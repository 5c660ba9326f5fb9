"""The reference's steps of a fleet frame, on the frozen eager copy
(``xmat_ref``): the tracker, the match-driven filter step, the keyframe step
and the REQUEST_COMM round, each from the state it is given, plus the fleet's
initial state and the vocabulary, which it works out from the benchmark's
inputs alone. Every function is plain PyTorch, op by op, on the device of its
inputs; the caller sets the matmul precision."""
from __future__ import annotations

import numpy as np
import torch

from ..harness.tree import build
from .xmat_ref.ekf import ekf as ekf_mod
from .xmat_ref.parallel import collab
from .xmat_ref.place_recognition import database as db_mod
from .xmat_ref.place_recognition import descriptors
from .xmat_ref.place_recognition.vocabulary import train_kmajority
from .xmat_ref.vio import pipeline
from .xmat_ref.vio import track_manager as tm
from .xmat_ref.vio import vio as vio_mod
from .xmat_ref.vision import camera as cam_mod
from .xmat_ref.vision import tracker as trk

PACKAGE = __name__.rsplit(".", 1)[0] + ".xmat_ref"  # the package the judge maps states onto


class Reference:
    """One configuration's parameter sets in the reference's classes."""

    def __init__(self, config: dict, agents: int):
        self.params = build(vio_mod.VioParams, config["vio"])
        self.tparams = build(trk.TrackerParams, config["tracker"]) if "tracker" in config else None
        self.cam = build(cam_mod.Camera, config["camera"]) if "camera" in config else None
        self.seed = int(config.get("tracker_seed", 0))
        self.ccfg = build(collab.CollabConfig, config["collab"]) if "collab" in config else None
        self.db_dims = (build(db_mod.DbDims, config["keyframe_db"])
                        if "keyframe_db" in config else None)
        self.vocab = config.get("vocabulary")
        self.agents = agents

    def init(self, start, device):
        """(fs, slots) of every agent at t = 0 at its true state ``start``
        = (p0, v0, q0), each (A, k)."""
        p0, v0, q0 = (x.cpu().numpy() for x in start)
        return vio_mod.init_at_time(self.params, 0.0, self.agents, device, p=p0, v=v0, q=q0)

    def tracker_zero(self, h: int, w: int, device):
        return trk.TrackerState.zero(self.tparams, self.agents, h, w, device=device)

    def track(self, tstate, image):
        """One tracker frame: (tstate, matches)."""
        return trk.track_frame_batch(self.tparams, self.cam, tstate, image, seed=self.seed)

    def matches(self, track_id, prev_pt, cur_pt, valid):
        return tm.Matches.of(track_id, prev_pt, cur_pt, valid)

    def filter(self, fs, slots, inputs: dict, matches):
        """One match-driven filter step on ``matches``: the IMU batch, then
        the visual update. Returns (fs, slots, applied)."""
        p = self.params
        meas = pipeline.FrameMeasurement.from_matches(p.cfg, matches)
        fs = ekf_mod.process_imu_batch_impl(p.ekf_params, fs, inputs["times"], inputs["seqs"],
                                            inputs["w_m"], inputs["a_m"])
        return vio_mod.process_matches(p, fs, slots, inputs["meas_time"], meas)

    def vocabulary(self, image, tstate) -> torch.Tensor:
        """The words, trained on the fleet's descriptors of ``image`` at the
        tracker state's live features (host k-majority)."""
        d0, ok0 = descriptors.compute(image, tstate.pts, tstate.ids >= 0)
        pool = d0[ok0].cpu().numpy()
        words = train_kmajority(pool, self.vocab["words"], seed=self.vocab["seed"]).words
        return torch.from_numpy(np.ascontiguousarray(words)).to(image.device)

    def db_zero(self, fs, slots):
        db = db_mod.KeyframeDB.zero(self.db_dims, collab.extract_payload_desc(self.params, fs,
                                                                                slots))
        return db, collab.KfMeta.zero(self.agents, fs.cov.dtype, fs.cov.device)

    def keyframe(self, words, fs, slots, db, kf_meta, applied):
        """The keyframe step: (db, kf_meta, selected)."""
        return collab.maybe_add_keyframe(self.params, self.db_dims, words, fs, slots, db, kf_meta,
                                         enabled=applied)

    def round(self, words, fs, slots, db):
        """One REQUEST_COMM round: (fs, db, hits, n_matches)."""
        return collab.request_response_round(self.params, self.ccfg, words, fs, slots, db)
