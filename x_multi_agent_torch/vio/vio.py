"""VIO entry functions and the single-agent facade (port of
``x_multi_agent_tpu.vio.vio``): the parameter set, the initial covariance,
``init_at_time``, the match-driven ``process_matches`` (and its debug form),
and the stateful :class:`VIO`, which holds one agent's state with an agent
axis of 1, with its collaboration (keyframes, requests, the match store).
The facade's photometric calibration and debug-image render are not
ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ekf import buffer as rb
from ..ekf import ekf as ekf_mod
from ..ekf.propagator import ImuNoise
from ..ekf.state import CoreState, FilterState, VisionState
from ..ops import lie, linalg
from . import pipeline
from . import track_manager as tm


class VioParams(NamedTuple):
    """Full static parameter set."""

    cfg: pipeline.VioConfig = pipeline.VioConfig()
    g: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    imu_noise: ImuNoise = ImuNoise()
    # initial std devs (reference sigma_dp/dv/dtheta[deg]/dbw[deg/s]/dba)
    sigma_dp: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sigma_dv: Tuple[float, float, float] = (0.05, 0.05, 0.05)
    sigma_dtheta_deg: Tuple[float, float, float] = (3.0, 3.0, 3.0)
    sigma_dbw_deg: Tuple[float, float, float] = (6.0, 6.0, 6.0)
    sigma_dba: Tuple[float, float, float] = (0.3, 0.3, 0.3)
    a_m_max: float = 50.0
    time_margin: float = 0.02
    max_update_lag: int = 64
    self_init_samples: int = 50
    dtype: str = "float32"

    @property
    def ekf_params(self) -> ekf_mod.EkfParams:
        return ekf_mod.EkfParams(
            dims=self.cfg.dims, g=self.g, imu_noise=self.imu_noise,
            a_m_max=self.a_m_max, time_margin=self.time_margin,
            max_update_lag=self.max_update_lag,
        )

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def make_initial_covariance(params: VioParams, device=None) -> torch.Tensor:
    """P0 = diag(sigma^2) on the core block; pose/feature blocks start at 0."""
    dims = params.cfg.dims
    deg = np.pi / 180.0
    sig = np.concatenate([
        np.asarray(params.sigma_dp),
        np.asarray(params.sigma_dv),
        np.asarray(params.sigma_dtheta_deg) * deg,
        np.asarray(params.sigma_dbw_deg) * deg,
        np.asarray(params.sigma_dba),
        np.zeros(6 * dims.n_poses + 3 * dims.n_features),
    ])
    return torch.as_tensor(np.diag(sig * sig), dtype=params.tdtype, device=device)


def init_at_time(
    params: VioParams, time: float, n_agents: int, device, p=None, v=None, q=None,
    b_w=None, b_a=None, core_cov=None,
) -> Tuple[FilterState, tm.TrackSlots]:
    """Zero vision state, sigma-diagonal covariance, standby until the first
    IMU sample — for ``n_agents`` agents that start from the same state.
    ``core_cov`` (15, 15) replaces the core block of the initial covariance
    (the re-initialization path carries the pre-reset core uncertainty)."""
    dt = params.tdtype
    dims = params.cfg.dims
    a = n_agents

    def vec(x, default):
        t = default if x is None else torch.as_tensor(np.asarray(x), dtype=dt, device=device)
        return t.expand(a, t.shape[-1]).clone()

    z3 = torch.zeros(3, dtype=dt, device=device)
    core = CoreState(
        time=torch.full((a,), float(time), dtype=dt, device=device),
        seq=torch.zeros((a,), dtype=torch.int32, device=device),
        p=vec(p, z3), v=vec(v, z3), q=vec(q, lie.quat_identity(dt, device)),
        b_w=vec(b_w, z3), b_a=vec(b_a, z3), w_m=vec(None, z3),
        a_m=vec(None, -torch.tensor(params.g, dtype=dt, device=device)),  # gravity reaction
    )
    cov0 = make_initial_covariance(params, device).expand(a, dims.d, dims.d).clone()
    if core_cov is not None:
        cov0[:, :15, :15] = torch.as_tensor(np.asarray(core_cov), dtype=dt, device=device)
    fs = ekf_mod.init_from_state(params.ekf_params, core, VisionState.zero(dims, a, dt, device), cov0)
    return fs, tm.TrackSlots.zero(params.cfg.tracks, a, dt, device)


def process_matches(params: VioParams, fs, slots, meas_time, meas: pipeline.FrameMeasurement):
    """Visual update driven by a match list (per agent). Returns
    (fs, slots, applied (A,))."""

    def update_fn(core, vision, cov, slots):
        return pipeline.visual_update(params.cfg, core, vision, cov, slots, meas)

    return ekf_mod.process_update_aux_impl(params.ekf_params, fs, meas_time, update_fn, slots)


def process_matches_debug(params: VioParams, fs, slots, meas_time, meas: pipeline.FrameMeasurement):
    """:func:`process_matches` that also returns the frame's
    :class:`pipeline.FrameDebug`. Returns (fs, slots, applied (A,), debug)."""

    def update_fn(core, vision, cov, aux):
        core, vision, cov, slots, dbg = pipeline.visual_update(
            params.cfg, core, vision, cov, aux[0], meas, return_debug=True
        )
        return core, vision, cov, (slots, dbg)

    dbg0 = pipeline.FrameDebug.zero(params.cfg, fs.cov.shape[0], fs.cov.dtype, fs.cov.device)
    fs, (slots, dbg), applied = ekf_mod.process_update_aux_impl(
        params.ekf_params, fs, meas_time, update_fn, (slots, dbg0)
    )
    return fs, slots, applied, dbg


class VIO:
    """Stateful single-agent facade (the reference's ``VIO``): the filter,
    track slots and tracker of one agent, held with an agent axis of 1, on
    ``device``. It reads results back to the host where the reference's
    facade does (match counts, ``applied``, the health monitor). On a CUDA
    device its IMU and update entries raise if TF32 matmuls are on."""

    def __init__(self, params: VioParams = VioParams(), self_init: bool = False,
                 debug: bool = False, device=None):
        self.params = params
        self.device = torch.device("cpu" if device is None else device)
        self.fs: Optional[FilterState] = None
        self.slots: Optional[tm.TrackSlots] = None
        self._accel_batch = []
        self._self_init = self_init
        self._last_range = None
        self._last_sun = None
        self._debug = debug
        self.last_debug: Optional[pipeline.FrameDebug] = None
        self._last_matches: Optional[tm.Matches] = None
        self._health = None
        self.n_reinits = 0
        self._reinit_streak = 0
        self._healthy_frames = 0

    def _batch(self, x, dtype=torch.float64) -> torch.Tensor:
        """Host value (or tensor) -> tensor with the agent axis of 1."""
        return torch.as_tensor(x, dtype=dtype, device=self.device)[None]

    # -- setup / init -------------------------------------------------------

    def init_at_time(self, t: float, **kwargs):
        self.fs, self.slots = init_at_time(self.params, t, 1, self.device, **kwargs)

    # -- failure detection / recovery ----------------------------------------

    def enable_health_monitor(self, min_matches: int = 8, max_bad_frames: int = 15,
                              cov_pos_max: Optional[float] = 100.0):
        """Divergence detection + automatic re-initialization, as the
        reference: frames with fewer than ``min_matches`` valid matches skip
        the update; a frame is unhealthy when it was gated or dropped, the
        tail went non-finite, or trace(P_pp) exceeds ``cov_pos_max`` without
        shrinking; ``max_bad_frames`` unhealthy frames in a row re-initialize
        from the tail estimate and open a grace window of twice as many
        frames."""
        self._health = dict(min_matches=int(min_matches), max_bad=int(max_bad_frames),
                            cov_pos_max=cov_pos_max)
        self._bad_frames = 0
        self._grace = 0
        self._last_cov_tr = None

    def _reinit_from_current(self):
        """Re-init at the tail estimate, carrying the core covariance
        (floored at the initial sigmas). A second re-init before a sustained
        healthy run escalates: velocity and biases restart at zero under a
        wide prior."""
        core = self.tail_state()
        vals = {k: getattr(core, k)[0].cpu().numpy() for k in ("p", "v", "q", "b_w", "b_a")}
        core_cov = self.fs.cov[0, :15, :15].cpu().numpy()
        init = make_initial_covariance(self.params).numpy()[:15, :15]
        if self._reinit_streak >= 1:
            vals["v"] = np.zeros(3)
            vals["b_w"] = np.zeros(3)
            vals["b_a"] = np.zeros(3)
            core_cov = init.copy()
            core_cov[3:6, 3:6] = np.eye(3) * 3.0**2
            core_cov[6:9, 6:9] = np.maximum(core_cov[6:9, 6:9], np.eye(3) * 0.3**2)
        self._reinit_streak += 1
        if not all(np.isfinite(v).all() for v in vals.values()):
            vals = dict(p=None, v=None, q=None, b_w=None, b_a=None)
        if not np.isfinite(core_cov).all():
            core_cov = None
        else:
            init_diag = np.diag(init)
            scale = np.sqrt(np.maximum(init_diag / np.maximum(np.diag(core_cov), 1e-30), 1.0))
            core_cov = core_cov * scale[:, None] * scale[None, :]
        self.init_at_time(float(core.time[0]), core_cov=core_cov, **vals)
        if self._collab_enabled:
            # stored matches and keyframe-selection state refer to pre-reset
            # landmarks: drop them (the keyframe DB keeps serving peers)
            self._reset_collab_state()
        self._bad_frames = 0
        self.n_reinits += 1

    def _health_post_update(self, applied: bool):
        h = self._health
        healthy = applied
        if healthy:
            healthy = bool(torch.isfinite(self.tail_state().p).all())
        if healthy and h["cov_pos_max"] is not None:
            tr = float(torch.trace(self.fs.cov[0, :3, :3]))
            last = self._last_cov_tr
            shrinking = last is not None and tr < 0.98 * last
            healthy = bool(np.isfinite(tr)) and (tr < h["cov_pos_max"] or shrinking)
            self._last_cov_tr = tr if np.isfinite(tr) else None
        self._healthy_frames = self._healthy_frames + 1 if healthy else 0
        if self._healthy_frames >= 2 * h["max_bad"]:
            self._reinit_streak = 0
        if self._grace > 0:
            self._grace -= 1
            if healthy:
                self._bad_frames = 0
            return
        self._bad_frames = 0 if healthy else self._bad_frames + 1
        if self._bad_frames >= h["max_bad"]:
            self._reinit_from_current()
            self._grace = 2 * h["max_bad"]

    # -- IMU ----------------------------------------------------------------

    def process_imu(self, t: float, seq: int, w_m, a_m):
        """One IMU sample, with the reference's gravity-aligned self-init
        over the first ``self_init_samples`` samples."""
        if self._self_init:
            self._accel_batch.append(np.asarray(a_m, float))
            if len(self._accel_batch) <= self.params.self_init_samples:
                return None
            avg_a = np.mean(self._accel_batch, axis=0)
            g_up = np.array([0.0, 0.0, np.linalg.norm(np.asarray(a_m, float))])
            self.init_at_time(t, q=_quat_from_two_vectors(avg_a, g_up))
            self._accel_batch.clear()
            self._self_init = False
            return None
        linalg.require_fp32_matmul(self.device, "VIO.process_imu")
        self.fs = ekf_mod.process_imu_impl(
            self.params.ekf_params, self.fs, self._batch(t), self._batch(seq, torch.int32),
            self._batch(w_m), self._batch(a_m),
        )
        return ekf_mod.tail_core(self.fs)

    def process_imu_batch(self, times, seqs, w_ms, a_ms):
        """L IMU samples at once (times, seqs (L,); w_ms, a_ms (L, 3))."""
        linalg.require_fp32_matmul(self.device, "VIO.process_imu_batch")
        self.fs = ekf_mod.process_imu_batch_impl(
            self.params.ekf_params, self.fs, self._batch(times), self._batch(seqs, torch.int32),
            self._batch(w_ms), self._batch(a_ms),
        )
        return ekf_mod.tail_core(self.fs)

    # -- aux sensors ---------------------------------------------------------

    def set_last_range_measurement(self, range_value: float, img_pt_n):
        """Consumed by the next visual update (facet selected there)."""
        self._last_range = (range_value, np.asarray(img_pt_n))

    def set_last_sun_angle_measurement(self, x_angle: float, y_angle: float):
        self._last_sun = (x_angle, y_angle)

    # -- image path ----------------------------------------------------------

    def setup_tracker(self, tracker_params, camera, img_height: int, img_width: int,
                      generator=0):
        """Attach the vision front end. ``generator``: a ``torch.Generator``
        on the facade's device, or a seed for one; it draws the RANSAC
        hypotheses."""
        from ..vision import tracker as trk_mod

        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=self.device).manual_seed(int(generator))
        self._tracker_params = tracker_params
        self._camera = camera
        self._generator = generator
        self._tracker_state = trk_mod.TrackerState.zero(
            tracker_params, 1, img_height, img_width, self.params.tdtype, self.device
        )

    def process_image_measurement(self, t: float, seq: int, img, ransac_idx=None):
        """Track features in the (H, W) image, then run the visual update.
        ``ransac_idx`` (1, S, 8) replaces the generator's RANSAC draws."""
        from ..vision import tracker as trk_mod

        img = torch.as_tensor(img, dtype=self.params.tdtype, device=self.device)
        self._tracker_state, matches = trk_mod.track_frame(
            self._tracker_params, self._camera, self._tracker_state, img,
            generator=self._generator, ransac_idx=ransac_idx,
        )
        # pad/crop the tracker's match budget to the pipeline's budget
        jm = self.params.cfg.tracks.n_matches
        jt = matches.valid.shape[1]
        if jt != jm:
            def fit(x, fill=0):
                if jt > jm:
                    return x[:, :jm]
                pad = x.new_full((1, jm - jt) + x.shape[2:], fill)
                return torch.cat([x, pad], dim=1)

            matches = tm.Matches(
                track_id=fit(matches.track_id, -1), prev_pt=fit(matches.prev_pt),
                cur_pt=fit(matches.cur_pt), valid=fit(matches.valid), desc=fit(matches.desc),
                desc_valid=fit(matches.desc_valid), tile=fit(matches.tile, -1),
                level=fit(matches.level),
            )
        return self.process_matches_measurement(t, seq, matches)

    # -- visual updates -------------------------------------------------------

    def process_matches_measurement(self, t: float, seq: int, matches: tm.Matches) -> bool:
        """The visual update from one frame's matches (agent axis of 1)."""
        linalg.require_fp32_matmul(self.device, "VIO.process_matches_measurement")
        dt = self.params.tdtype
        if self._health is not None:
            # tracking-quality gate: starved frames are withheld from the filter
            if int(matches.valid.sum()) < self._health["min_matches"]:
                self._last_matches = matches
                self._health_post_update(False)
                return False
        meas = pipeline.FrameMeasurement.from_matches(self.params.cfg, matches)
        if self._last_range is not None:
            rv, pt = self._last_range
            meas = meas._replace(
                range_value=self._batch(rv, dt), range_img_pt=self._batch(pt, dt),
                range_active=self._batch(True, torch.bool),
            )
            self._last_range = None
        if self._last_sun is not None:
            meas = meas._replace(sun_angles=self._batch(self._last_sun, dt),
                                 sun_active=self._batch(True, torch.bool))
            self._last_sun = None
        self._last_matches = matches
        if self._collab_enabled:
            from ..parallel import collab as collab_mod

            (self.fs, self.slots, self._store, self._db, self._kf_meta, applied, kf_sel,
             n_collab) = collab_mod.process_matches_collab(
                self.params, self._ccfg, self._db_dims, self._words, self.fs, self.slots,
                self._store, self._db, self._kf_meta, self._batch(t), meas,
            )
            self.n_collab_consumed = self.n_collab_consumed + n_collab[0]
            self.n_keyframes_selected += int(kf_sel[0])
            applied = bool(applied[0])
        elif self._debug:
            self.fs, self.slots, applied, dbg = process_matches_debug(
                self.params, self.fs, self.slots, self._batch(t), meas
            )
            applied = bool(applied[0])
            if applied:  # dropped updates keep the last real payload
                self.last_debug = dbg
        else:
            self.fs, self.slots, applied = process_matches(
                self.params, self.fs, self.slots, self._batch(t), meas
            )
            applied = bool(applied[0])
        if self._health is not None:
            self._health_post_update(applied)
        return applied

    # -- multi-agent collaboration (request-response) ---------------------------

    def enable_collab(self, words, uav_id: int = 0, db_dims=None, ccfg=None, store_dims=None,
                      generator=0):
        """Attach the collaborative stack: keyframe ring with VLAD
        vocabulary ``words`` (W, 32) and a persistent cross-agent match
        store. After this every applied visual update runs the
        keyframe-selection heuristic and consumes stored matches.
        ``generator`` (a ``torch.Generator`` on the facade's device, or a
        seed) draws the RANSAC gates' hypotheses; ``self.sampler`` may be
        replaced by any ``ops.ransac.generator_sampler``-style callable."""
        from ..ops.ransac import generator_sampler
        from ..parallel import collab as collab_mod, match_store as ms_mod
        from ..place_recognition import database as db_mod

        if self.fs is None:
            raise RuntimeError("call init_at_time first")
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=self.device).manual_seed(int(generator))
        self._words = torch.as_tensor(words, dtype=torch.uint8, device=self.device)
        self._uav_id = int(uav_id)
        self._db_dims = db_dims or db_mod.DbDims(n_words=int(self._words.shape[0]))
        self._ccfg = ccfg or collab_mod.CollabConfig()
        self._store_dims = store_dims or ms_mod.StoreDims()
        self.sampler = generator_sampler(generator)
        proto = collab_mod.extract_payload_desc(self.params, self.fs, self.slots)
        self._db = db_mod.KeyframeDB.zero(self._db_dims, proto)
        self._reset_collab_state()
        self.n_keyframes_selected = 0
        self.n_collab_consumed = torch.zeros((), dtype=torch.int32, device=self.device)

    def _reset_collab_state(self):
        from ..parallel import collab as collab_mod, match_store as ms_mod

        dt = self.params.tdtype
        self._store = ms_mod.MatchStore.zero(self.params.cfg.dims, self._store_dims, 1,
                                             dtype=dt, device=self.device)
        self._kf_meta = collab_mod.KfMeta.zero(1, dt, self.device)
        self._fuse_recency = {}

    @property
    def _collab_enabled(self) -> bool:
        return getattr(self, "_db", None) is not None

    def get_data_to_send(self):
        """Full-broadcast payload (agent axis of 1)."""
        from ..parallel import collab as collab_mod

        return collab_mod.extract_payload_desc(self.params, self.fs, self.slots)

    def get_descriptors(self) -> torch.Tensor:
        """Requester side: the VLAD (1, W, 32) of the current frame's track
        descriptors."""
        from ..parallel import collab as collab_mod

        return collab_mod.query_vlad(self._words, self.slots)

    def process_other_requests(self, requester_id: int, vlad):
        """Responder side: the best keyframe not yet served to
        ``requester_id`` whose VLAD score beats ``pr_score_thr``. Returns
        (payload, found); ship the payload only when found."""
        from ..place_recognition import database as db_mod

        vlad = torch.as_tensor(vlad, dtype=torch.uint8, device=self.device).reshape(
            (1,) + self._words.shape)
        idx, found, self._db = db_mod.find_candidate(
            self._db, int(requester_id), vlad, self._ccfg.pr_score_thr
        )
        return db_mod.get_keyframe(self._db, idx), bool(found[0])

    def process_other_measurements(self, payload, uav_id: int, valid=True) -> int:
        """Receive a peer payload (agent axis of 1): SLAM-SLAM matches
        CI-fuse at once; OPP matches are recorded for later visual updates.
        With ``ccfg.refuse_cooldown > 0`` a per-peer recency table gates the
        re-fusion of an own landmark against the same peer. Returns the
        number of matches fused now."""
        from ..parallel import collab as collab_mod

        linalg.require_fp32_matmul(self.device, "VIO.process_other_measurements")
        recency = None
        if self._ccfg.refuse_cooldown > 0:
            recency = self._fuse_recency.get(uav_id) or collab_mod.fresh_recency(self.slots)
        self.fs, self._store, n, recency1 = collab_mod.receive_and_record(
            self.params, self._ccfg, self.fs, self.slots, self._store, payload,
            self._batch(uav_id, torch.int32), self._batch(bool(valid), torch.bool),
            recency=recency, sampler=self.sampler,
        )
        if recency is not None:
            last_id, last_cnt, cnt = recency1
            self._fuse_recency[uav_id] = (last_id, last_cnt, cnt + 1)
        return int(n[0])

    # -- telemetry -------------------------------------------------------------

    def tail_state(self) -> CoreState:
        return ekf_mod.tail_core(self.fs)

    def anchor_state(self) -> CoreState:
        return rb.get_slot(self.fs.buffer, self.fs.anchor_buf_idx)

    def get_msckf_tracks(self):
        """MSCKF inlier and outlier observations of the last visual update,
        numpy (K, 2) normalized coordinates; needs ``debug=True``."""
        d = self.last_debug
        if d is None:
            return np.zeros((0, 2)), np.zeros((0, 2))
        pts = d.msckf_cur[0].cpu().numpy()
        valid = d.msckf_valid[0].cpu().numpy()
        inl = d.msckf_inlier[0].cpu().numpy()
        return pts[valid & inl], pts[valid & ~inl]

    def get_slam_features_cartesian(self):
        """World-frame SLAM landmarks of the last visual update, numpy
        (n_valid, 3); needs ``debug=True``."""
        d = self.last_debug
        if d is None:
            return np.zeros((0, 3))
        return d.slam_cartesian[0].cpu().numpy()[d.slam_cart_valid[0].cpu().numpy()]


def _quat_from_two_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Quaternion (xyzw) rotating a onto b (Eigen setFromTwoVectors)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    c = np.cross(a, b)
    w = 1.0 + a @ b
    if w < 1e-9:  # antiparallel: pick any orthogonal axis
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return np.array([axis[0], axis[1], axis[2], 0.0])
    q = np.array([c[0], c[1], c[2], w])
    return q / np.linalg.norm(q)
