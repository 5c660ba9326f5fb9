"""The system under test: a fleet of agents on the PyTorch package's compiled
main path, fed from the benchmark's ring, one fleet frame per call.

Per frame, by the traffic file:

* ``input: image``: ``vio.frame_step.CompiledFrameStep`` (the tracker's
  graphs around its detection gate, then the filter step's graph);
* ``input: matches``: ``parallel.mesh.agent_step_fn`` (the reference's
  ``processMatchesMeasurement`` mode: the IMU batch and the visual update);
* ``keyframes: true``: then ``parallel.collab.maybe_add_keyframe`` (the
  vocabulary is trained on the fleet's descriptors after frame 0, as the
  JAX package's chip runs do);
* ``exchange_every: n > 0``: after every n-th frame,
  ``collab.request_response_round``.

Spans (``clock.Spans``) wrap the calls into each layer: ``tracker`` and
``filter`` (the frame step's two programs), ``keyframe`` and ``round``.
A frame given a ``record`` dict clones what each stage returned into it,
for the judge (``check.py``)."""
from __future__ import annotations

import numpy as np
import torch

from . import inputs as inputs_mod
from .tree import build, clone, leaves

PACKAGE = "x_multi_agent_torch"


class Fleet:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device, spans,
                 make_ring=inputs_mod.make_ring):
        from x_multi_agent_torch.parallel import collab
        from x_multi_agent_torch.parallel.mesh import agent_step_fn
        from x_multi_agent_torch.place_recognition import database as db_mod
        from x_multi_agent_torch.vio import pipeline
        from x_multi_agent_torch.vio import track_manager as tm
        from x_multi_agent_torch.vio import vio as vio_mod
        from x_multi_agent_torch.vio.frame_step import CompiledFrameStep
        from x_multi_agent_torch.vision import camera as cam_mod
        from x_multi_agent_torch.vision import tracker as trk

        self.device, self.mix, self.config = device, mix, config
        self.agents = a = int(mix["agents"])
        self.params = params = build(vio_mod.VioParams, config["vio"])
        self.ring = make_ring(mix, a, config, seed, device)
        p0, v0, q0 = (x.cpu().numpy() for x in self.ring.start)
        self.fs, self.slots = vio_mod.init_at_time(params, 0.0, a, device, p=p0, v=v0, q=q0)
        self.image = mix["input"] == "image"
        self.tstate = None
        if self.image:
            self.tparams = build(trk.TrackerParams, config["tracker"])
            cam = build(cam_mod.Camera, config["camera"])
            h, w = config["image"]["height"], config["image"]["width"]
            self.tstate = trk.TrackerState.zero(self.tparams, a, h, w, device=device)
            self.step = CompiledFrameStep(params, self.tparams, cam, seed=int(config["tracker_seed"]))
            self.tracker_graphs = self.step.tracker.graphs
            self.graphs = self.step.graphs
            self.step.tracker = spans.wrap("tracker", self.step.tracker)
            self.step.step = spans.wrap("filter", self.step.step)
        else:
            prog = agent_step_fn(params)
            self.graphs = (prog.graphs,)
            self.prog = spans.wrap("filter", prog)
            j = config["vio"]["cfg"]["tracks"]["n_matches"]
            dt = params.tdtype

            def zeros(*shape, dtype=dt):
                return torch.zeros(shape, dtype=dtype, device=device)

            # the fields the ring does not vary, made once (Matches.of and
            # FrameMeasurement.from_matches would make them every frame)
            self._match_const = dict(desc=zeros(a, j, 32, dtype=torch.uint8),
                                     desc_valid=zeros(a, j, dtype=torch.bool),
                                     tile=torch.full((a, j), -1, dtype=torch.int32, device=device),
                                     level=zeros(a, j, dtype=torch.int32))
            self._meas_const = dict(range_value=zeros(a), range_img_pt=zeros(a, 2),
                                    range_active=zeros(a, dtype=torch.bool), sun_angles=zeros(a, 2),
                                    sun_active=zeros(a, dtype=torch.bool))
            self._tm, self._pipeline = tm, pipeline
        self.keyframes = bool(mix.get("keyframes", False))
        self.every = int(mix.get("exchange_every", 0))
        self.words = self.db = self.kf_meta = None
        if self.keyframes:
            self.ccfg = build(collab.CollabConfig, config["collab"])
            self.db_dims = build(db_mod.DbDims, config["keyframe_db"])
            self._collab, self._db_mod = collab, db_mod
            self.keyframe = spans.wrap("keyframe", collab.maybe_add_keyframe)
            self.round = spans.wrap("round", collab.request_response_round)
        self.rounds = []  # (frame, hits (A, A) bool) of every round run

    def checkable(self, k: int) -> bool:
        """Whether frame ``k`` runs every stage (a round, where the mix has
        rounds), so that a check there covers them all."""
        return not self.every or (k + 1) % self.every == 0

    def state(self):
        """A copy of the fleet's state between frames."""
        return clone({"tstate": self.tstate, "fs": self.fs, "slots": self.slots, "db": self.db,
                      "kf_meta": self.kf_meta})

    def restore(self, state) -> None:
        """Write a copy from :meth:`state` back into the fleet's buffers."""
        for key in ("tstate", "fs", "slots", "db", "kf_meta"):
            dst = leaves(getattr(self, key))
            for path, x in leaves(state[key]).items():
                dst[path].copy_(x)

    def frame(self, k: int, record=None) -> None:
        x = self.ring.frame(k)
        if self.image:
            self.tstate, self.fs, self.slots, matches, applied = self.step(
                self.tstate, self.fs, self.slots, x["image"], x["times"], x["seqs"], x["w_m"],
                x["a_m"], x["meas_time"])
        else:
            matches = self._tm.Matches(x["track_id"], x["prev_pt"], x["cur_pt"], x["valid"],
                                       **self._match_const)
            meas = self._pipeline.FrameMeasurement(matches=matches, **self._meas_const)
            self.fs, self.slots, applied = self.prog(self.fs, self.slots, x["times"], x["seqs"],
                                                     x["w_m"], x["a_m"], x["meas_time"], meas)
        if record is not None:
            record["frame"] = clone({"tstate": self.tstate, "fs": self.fs, "slots": self.slots,
                                     "matches": matches, "applied": applied})
        if not self.keyframes:
            return
        if self.words is None:
            self._vocabulary(x["image"], record)
        self.db, self.kf_meta, sel = self.keyframe(self.params, self.db_dims, self.words, self.fs,
                                                   self.slots, self.db, self.kf_meta,
                                                   enabled=applied)
        if record is not None:
            record["keyframe"] = clone({"db": self.db, "kf_meta": self.kf_meta, "sel": sel})
        if self.every and (k + 1) % self.every == 0:
            self.fs, self.db, hits, n = self.round(self.params, self.ccfg, self.words, self.fs,
                                                   self.slots, self.db)
            self.rounds.append((k, hits))
            if record is not None:
                record["round"] = clone({"fs": self.fs, "db": self.db, "hits": hits,
                                         "n_matches": n})

    def _vocabulary(self, image, record) -> None:
        """The words from the fleet's descriptors at its live features after
        its first frame, and an empty keyframe database."""
        from x_multi_agent_torch.place_recognition import descriptors
        from x_multi_agent_torch.place_recognition.vocabulary import train_kmajority

        d0, ok0 = descriptors.compute(image, self.tstate.pts, self.tstate.ids >= 0)
        voc = self.config["vocabulary"]
        words = train_kmajority(d0[ok0].cpu().numpy(), voc["words"], seed=voc["seed"]).words
        self.words = torch.from_numpy(np.ascontiguousarray(words)).to(self.device)
        proto = self._collab.extract_payload_desc(self.params, self.fs, self.slots)
        self.db = self._db_mod.KeyframeDB.zero(self.db_dims, proto)
        self.kf_meta = self._collab.KfMeta.zero(self.agents, self.fs.cov.dtype, self.device)
        if record is not None:
            record["words"] = self.words.clone()

    def release(self) -> None:
        """Drop the programs (their graphs and memory pools) and the fleet's
        state; the ring and the settings stay for the judge."""
        self.step = self.prog = self.graphs = self.tracker_graphs = None
        self.keyframe = self.round = None
        self.tstate = self.fs = self.slots = self.db = self.kf_meta = None

    def payload_bytes(self) -> int:
        """Bytes of one keyframe payload, from the database's leaf shapes."""
        return sum(int(np.prod(x.shape[2:])) * x.element_size()
                   for x in leaves(self.db.payload).values())

    def live_features(self):
        """(A,) tracked slots the next tracker frame runs LK on (a device tensor)."""
        return ((self.tstate.ids >= 0) & self.tstate.has_prev[:, None]).sum()
