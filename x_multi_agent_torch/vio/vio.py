"""VIO entry functions and the single-agent facade (port of
``x_multi_agent_tpu.vio.vio``): the parameter set, the initial covariance,
``init_at_time``, the match-driven ``process_matches`` (and its debug form),
and the stateful :class:`VIO`, which holds one agent's state with an agent
axis of 1, with its online photometric calibration, its collaboration
(keyframes, requests, the match store) and its debug-image render.

The facade runs each per-frame call as compiled programs of its own
(``utils/graph.py``: CUDA graphs on the card), the counterpart of the
reference's ``jax.jit`` entries: the IMU sample and batch, the tracker, the
photometric correction, frame and spatial solve, the match-driven update
(plain, debug, collaborative) and the peer receive. They share the facade's
state as one carry, so ``fs``, ``slots`` and the collaboration state are
the programs' buffers between calls. ``VIO(..., compiled=False)`` is the
eager twin: the same functions, called op by op, for comparison.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from ..ekf import buffer as rb
from ..ekf import ekf as ekf_mod
from ..ekf.propagator import ImuNoise
from ..ekf.state import CoreState, FilterState, VisionState
from ..ops import lie, linalg
from ..ops.ransac import KeyedSampler
from ..photometric import calib
from ..utils import graph, tree
from ..utils.const import constant
from ..vision.image import bilinear_sample
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
    device = resolve(device)
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
    device = resolve(device)

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


class PhotoConfig(NamedTuple):
    """Static settings of the facade's photometric calibration."""

    dims: calib.PhotoDims
    epsilon_gap: float
    epsilon_base: float
    cell_px: int  # spatial cell size (pixels)
    n_cells_x: int
    n_cells_y: int
    spatial_every: int  # frames between spatial solves


@dataclass(frozen=True)
class SpatialRing:
    """Ring of spatial residual rows (ps[sid_cur] - ps[sid_hist] = rhs)."""

    sid_hist: torch.Tensor  # (S,) int32 cell ids
    sid_cur: torch.Tensor  # (S,) int32
    rhs: torch.Tensor  # (S,)
    valid: torch.Tensor  # (S,) bool
    ptr: int  # next row to write


@dataclass(frozen=True)
class FacadePhoto:
    """The facade's photometric calibration state: the gain chain, the ring
    of the last ``n_history`` frames' SAMPLED intensities at their tracked
    points (newest first; rows past ``n_hist`` are zeros with ids -1), the
    frame counter that keys the RANSAC draws, and with spatial calibration
    the residual ring and the (H, W) offset map (zeros until the first
    solve)."""

    state: calib.PhotoState
    hist_int: torch.Tensor  # (Fh, n) intensities in [0, 1]
    hist_pts: torch.Tensor  # (Fh, n, 2) tracked positions
    hist_ids: torch.Tensor  # (Fh, n) int32 track ids
    n_hist: int
    frame: int
    spatial: Optional[SpatialRing]
    ps: Optional[torch.Tensor]

    @staticmethod
    def zero(cfg: PhotoConfig, hw, spatial_rows: int, dtype, device) -> "FacadePhoto":
        fh, n = cfg.dims.n_history, cfg.dims.n_obs
        ring = None
        if spatial_rows:
            ring = SpatialRing(
                sid_hist=torch.zeros((spatial_rows,), dtype=torch.int32, device=device),
                sid_cur=torch.zeros((spatial_rows,), dtype=torch.int32, device=device),
                rhs=torch.zeros((spatial_rows,), dtype=dtype, device=device),
                valid=torch.zeros((spatial_rows,), dtype=torch.bool, device=device), ptr=0,
            )
        return FacadePhoto(
            state=calib.PhotoState.zero(cfg.dims, dtype, device),
            hist_int=torch.zeros((fh, n), dtype=dtype, device=device),
            hist_pts=torch.zeros((fh, n, 2), dtype=dtype, device=device),
            hist_ids=torch.full((fh, n), -1, dtype=torch.int32, device=device),
            n_hist=0, frame=0, spatial=ring,
            ps=torch.zeros(hw, dtype=dtype, device=device) if spatial_rows else None,
        )


def _photo_sample(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Mean of the 5-point cross around each tracked position, in [0, 1]: a
    point sample at a tracked peak is very sensitive to subpixel tracking
    error, the cross mean much less (it matters for spatial residuals)."""
    offs = constant(((0.0, 0.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0)),
                    pts.dtype, pts.device)
    return torch.mean(bilinear_sample(img, pts[None] + offs[:, None]), dim=0) / 255.0


def _cell_id(pts: torch.Tensor, cfg: PhotoConfig) -> torch.Tensor:
    div = cfg.cell_px
    cx = torch.clamp(torch.div(pts[..., 0], div, rounding_mode="floor").to(torch.int32),
                     0, cfg.n_cells_x - 1)
    cy = torch.clamp(torch.div(pts[..., 1], div, rounding_mode="floor").to(torch.int32),
                     0, cfg.n_cells_y - 1)
    return cy * cfg.n_cells_x + cx


def _accumulate_spatial(cfg: PhotoConfig, k: int, ring: tuple, ptr, hist_int, hist_pts,
                        state: calib.PhotoState, cur_pts, cur_int, pair_valid, a_cur, b_cur):
    """Append the spatial residual rows of the ``k`` real histories at once
    to ``ring`` = (sid_hist, sid_cur, rhs, valid) from row ``ptr`` (an int64
    tensor): after the per-frame global correction, the matched-intensity
    difference left is put on the per-cell offsets, ps[cell_cur] -
    ps[cell_prev] = corr_cur - corr_prev. Per history pair, an affine term
    alpha I + beta (the residual gain error between the two frames) is
    fitted on the same-cell rows, whose spatial expectation is zero, and
    removed when there are at least 5 of them. The rows go in history
    order, as the reference's per-history appends. Returns the ring."""
    sid_hist, sid_cur, rhs, valid = ring
    dev = cur_pts.device
    back = constant(tuple(range(1, k + 1)), torch.int32, dev)
    g_hist = state.params_pt[torch.remainder(state.frame_ptr - back, cfg.dims.window).long()]
    a_prev, b_prev = g_hist[:, :1], g_hist[:, 1:]
    rows = (cur_int * (a_cur - b_cur) + b_cur) - (hist_int[:k] * (a_prev - b_prev) + b_prev)
    sid_p = _cell_id(hist_pts[:k], cfg)  # (K, n)
    sid_c = _cell_id(cur_pts, cfg).expand_as(sid_p)
    same = (sid_p == sid_c) & pair_valid[:k]
    n_same = torch.sum(same, -1, keepdim=True)
    w_s = same.to(rows.dtype)
    sw = torch.clamp(torch.sum(w_s, -1, keepdim=True), min=1.0)
    mi = torch.sum(w_s * cur_int, -1, keepdim=True) / sw
    mr = torch.sum(w_s * rows, -1, keepdim=True) / sw
    var_i = torch.sum(w_s * (cur_int - mi) ** 2, -1, keepdim=True) / sw
    cov_ir = torch.sum(w_s * (cur_int - mi) * (rows - mr), -1, keepdim=True) / sw
    alpha = torch.where(var_i > 1e-6, cov_ir / torch.clamp(var_i, min=1e-6), 0.0)
    beta = mr - alpha * mi
    rows = torch.where(n_same >= 5, rows - (alpha * cur_int + beta), rows)
    idx = torch.remainder(ptr + torch.arange(rows.numel(), device=dev), valid.shape[0])
    return (sid_hist.index_copy(0, idx, sid_p.reshape(-1)),
            sid_cur.index_copy(0, idx, sid_c.reshape(-1)),
            rhs.index_copy(0, idx, rows.reshape(-1).to(rhs.dtype)),
            valid.index_copy(0, idx, pair_valid[:k].reshape(-1)))


def _photo_arrays(ph: FacadePhoto) -> tuple:
    """The device part of the photometric state, the photometric frame
    program's carry: (state, hist_int, hist_pts, hist_ids, the spatial ring's
    (sid_hist, sid_cur, rhs, valid) or None). Its Python counters stay on
    the host."""
    sp = ph.spatial
    ring = None if sp is None else (sp.sid_hist, sp.sid_cur, sp.rhs, sp.valid)
    return (ph.state, ph.hist_int, ph.hist_pts, ph.hist_ids, ring)


def photo_correct(state: calib.PhotoState, ps, img, dtype):
    """The raw frame in ``dtype`` and the frame corrected with the newest
    gains and the spatial map ``ps`` (or None). Returns (raw, corrected)."""
    raw = img.to(dtype)
    a, b = state.current().unbind(-1)
    return raw, calib.correct_image(raw, a, b, params_ps=ps).to(dtype)


def photo_frame(cfg: PhotoConfig, sampler, arrays: tuple, n_hist: int, raw, cur_pts, cur_ids,
                counters):
    """One frame of the facade's photometric calibration on its device
    state ``arrays`` (:func:`_photo_arrays`) holding ``n_hist`` real
    histories: sample the raw frame at the tracked points ``cur_pts`` (n,
    2) of the tracks ``cur_ids`` (n,), update the gain chain from every
    history at once (the reference's ``ProcessCurrentFrame``; the RANSAC
    draws from ``sampler`` keyed on (the frame counter, the history row)),
    append the spatial rows at the ring pointer, push this frame into the
    ring. ``counters`` (2,) float64 holds (the frame counter, the ring
    pointer). Returns (arrays,)."""
    state, hist_int, hist_pts, hist_ids, ring = arrays
    counters = counters.to(torch.int64)
    n, fh = cfg.dims.n_obs, cfg.dims.n_history
    dev = raw.device
    cur_int = _photo_sample(raw, cur_pts)
    if n_hist:
        pair_valid = (hist_ids == cur_ids) & (cur_ids >= 0)  # (Fh, n)
        offsets = constant(tuple(min(k + 1, n_hist) for k in range(fh)), torch.int32, dev)
        state, a_cur, b_cur = calib.process_frame(
            cfg.dims, state, hist_int, cur_int.expand(fh, n), pair_valid, offsets,
            sampler(pair_valid, counters[:1], constant(tuple(range(fh)), torch.int64, dev)),
            cfg.epsilon_gap, cfg.epsilon_base,
        )
        if ring is not None:
            ring = _accumulate_spatial(cfg, n_hist, ring, counters[1], hist_int, hist_pts, state,
                                       cur_pts, cur_int, pair_valid, a_cur, b_cur)
    return ((state, torch.cat([cur_int[None], hist_int[:-1]]),
             torch.cat([cur_pts[None], hist_pts[:-1]]), torch.cat([cur_ids[None], hist_ids[:-1]]),
             ring),)


def spatial_solve(cfg: PhotoConfig, hw, ps, ring: tuple):
    """The GPR-smoothed per-cell offset map from the spatial ring, expanded
    to the (H, W) frame (``ps`` is the map it replaces). Returns (ps,)."""
    cells = calib.estimate_spatial_parameters(cfg.n_cells_x, cfg.n_cells_y, *ring)
    return (calib.expand_spatial(cells, *hw, cfg.cell_px).to(ps.dtype),)


def frame_measurement(params: VioParams, x, matches: tm.Matches):
    """(meas_time (A,), FrameMeasurement) from one packed host row per agent,
    ``x`` (A, 8) float64 = (t, range value, range point (2), range active,
    sun angles (2), sun active), and the matches: the range and sun rows
    count where their flags are set (zeros elsewhere, as
    ``FrameMeasurement.from_matches``)."""
    dt = params.tdtype
    return x[:, 0], pipeline.FrameMeasurement(
        matches=matches, range_value=x[:, 1].to(dt), range_img_pt=x[:, 2:4].to(dt),
        range_active=x[:, 4] != 0, sun_angles=x[:, 5:7].to(dt), sun_active=x[:, 7] != 0,
    )


def update_report(fs, applied, selected=None):
    """What the host reads after an update, one float64 row per agent:
    (applied, the tail position finite, the trace of the position
    covariance, a keyframe selected)."""
    sel = torch.zeros_like(applied) if selected is None else selected
    tr = torch.diagonal(fs.cov[:, :3, :3], dim1=-2, dim2=-1).sum(-1)
    fin = torch.isfinite(ekf_mod.tail_core(fs).p).all(-1)
    return torch.stack([c.to(torch.float64) for c in (applied, fin, tr, sel)], -1)


def match_update(params: VioParams, fs, slots, x, matches):
    """The facade's match-driven update program: :func:`process_matches` on
    the packed row ``x`` (:func:`frame_measurement`). Returns (fs, slots,
    report (A, 4))."""
    fs, slots, applied = process_matches(params, fs, slots, *frame_measurement(params, x, matches))
    return fs, slots, update_report(fs, applied)


def match_update_debug(params: VioParams, fs, slots, x, matches):
    """:func:`match_update` through :func:`process_matches_debug`. Returns
    (fs, slots, report, debug)."""
    fs, slots, applied, dbg = process_matches_debug(params, fs, slots,
                                                    *frame_measurement(params, x, matches))
    return fs, slots, update_report(fs, applied), dbg


class VIO:
    """Stateful single-agent facade (the reference's ``VIO``): the filter,
    track slots and tracker of one agent, held with an agent axis of 1, on
    ``device``. It reads results back to the host where the reference's
    facade does (match counts, ``applied``, the health monitor). On a CUDA
    device its IMU and update entries raise if TF32 matmuls are on.

    Its per-frame calls run as programs it owns (module docstring): the
    states it holds (``fs``, ``slots``, ``photo``, the collaboration state)
    are their buffers, overwritten in place by the next call; keep a
    ``clone()`` to compare across calls. A program's other results (the IMU
    entries' tail state, a received peer's recency) are valid until its next
    call. ``compiled=False`` runs the same functions eagerly (the twin the
    comparisons hold the programs against)."""

    def __init__(self, params: VioParams = VioParams(), self_init: bool = False,
                 debug: bool = False, device=None, compiled: bool = True):
        self.params = params
        self.device = resolve(device)
        self.compiled = compiled
        self._carry = graph.Carry()
        self._programs = {}
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
        self.photo: Optional[FacadePhoto] = None

    def _upload(self, *cols) -> torch.Tensor:
        """Host values (each ``(value, shape)``), reshaped and concatenated
        along their last axis, as one float64 tensor on the device with the
        agent axis of 1: one copy from pinned memory on the card, which does
        not wait for its stream."""
        x = torch.from_numpy(np.concatenate([np.reshape(np.asarray(
            v.cpu() if isinstance(v, torch.Tensor) else v, np.float64), shape)
            for v, shape in cols], axis=-1))[None]
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def _run(self, name: str, fn, n_carry: int, *args, static=()):
        """``fn(*args)`` as this facade's program ``name``: compiled
        (``utils/graph.py``) with its first ``n_carry`` arguments carried in
        the facade's shared carry and ``static`` in its capture key, or
        called as it is by the eager twin."""
        if not self.compiled:
            return fn(*args)
        prog = self._programs.get(name)
        if prog is None:
            prog = self._programs[name] = graph.compiled(fn, f"VIO.{name}", n_carry, self._carry)
        return prog(*args, static=static)

    @property
    def programs(self) -> list:
        """The facade's compiled programs (``graph.Programs``), the tracker's
        included."""
        progs = list(self._programs.values())
        tracker = getattr(self, "_tracker", None)
        return progs + ([tracker] if isinstance(tracker, graph.Programs) else [])

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
        init = make_initial_covariance(self.params, "cpu").numpy()[:15, :15]
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

    def _health_post_update(self, applied: bool, report=None):
        """The monitor's step after an update whose host ``report`` (the
        update program's row: tail finite at [1], position trace at [2]) the
        facade read; ``report`` is unread when nothing applied."""
        h = self._health
        healthy = applied
        if healthy:
            healthy = bool(report[1])
        if healthy and h["cov_pos_max"] is not None:
            tr = float(report[2])
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
        x = self._upload((t, 1), (seq, 1), (w_m, 3), (a_m, 3))
        ekf_p = self.params.ekf_params
        self.fs, tail = self._run("process_imu", lambda fs, x: ekf_mod.process_imu_packed(
            ekf_p, fs, x), 1, self.fs, x)
        return tail

    def process_imu_batch(self, times, seqs, w_ms, a_ms):
        """L IMU samples at once (times, seqs (L,); w_ms, a_ms (L, 3)). The
        program captures once per L (``jax.jit`` compiles once per shape)."""
        linalg.require_fp32_matmul(self.device, "VIO.process_imu_batch")
        x = self._upload((times, (-1, 1)), (seqs, (-1, 1)), (w_ms, (-1, 3)), (a_ms, (-1, 3)))
        ekf_p = self.params.ekf_params
        self.fs, tail = self._run("process_imu_batch", lambda fs, x: ekf_mod.process_imu_batch_packed(
            ekf_p, fs, x), 1, self.fs, x)
        return tail

    # -- aux sensors ---------------------------------------------------------

    def set_last_range_measurement(self, range_value: float, img_pt_n):
        """Consumed by the next visual update (facet selected there)."""
        self._last_range = (range_value, np.asarray(img_pt_n))

    def set_last_sun_angle_measurement(self, x_angle: float, y_angle: float):
        self._last_sun = (x_angle, y_angle)

    # -- image path ----------------------------------------------------------

    def setup_tracker(self, tracker_params, camera, img_height: int, img_width: int,
                      seed: int = 0):
        """Attach the vision front end. The RANSAC hypotheses are keyed on
        (``seed``, the tracker state's id counter), so a restored tracker
        state draws what the uninterrupted run drew."""
        from ..vision import tracker as trk_mod

        self._tracker_params = tracker_params
        self._camera = camera
        self._seed = int(seed)
        self._img_hw = (img_height, img_width)
        self._tracker_state = trk_mod.TrackerState.zero(
            tracker_params, 1, img_height, img_width, self.params.tdtype, self.device
        )
        # the reference's track_frame_jit: this facade's own programs at A = 1
        self._tracker = (trk_mod.TrackerProgram(tracker_params, camera, "VIO.tracker")
                         if self.compiled else None)

    def enable_photometric(self, n_obs: int = 100, epsilon_gap: float = 0.02,
                           epsilon_base: float = 0.005, n_history: int = 3,
                           spatial: bool = False, cell_px: int = 40, spatial_every: int = 10,
                           spatial_window: int = 64, seed: int = 0):
        """Online thermal gain calibration (the reference's
        PHOTOMETRIC_CALI). Each image is corrected with the newest gains
        before tracking (a one-frame lag); after tracking, the gains update
        from the intensities of the first ``n_obs`` tracker slots in this
        frame and in up to ``n_history`` earlier ones (same slot, same
        track id).

        ``spatial=True`` also collects per-cell residual rows and, every
        ``spatial_every`` frames with at least 20 valid rows, solves the
        GPR-smoothed per-cell offset map (``cell_px`` cells, a ring of
        ``n_obs * spatial_window`` rows) that every later correction
        subtracts; that gate reads one count back to the host. The
        reference measured the spatial path harmful on static vignettes (a
        static field cancels out of frame-to-frame LK) and keeps it off by
        default, as here.

        The RANSAC hypotheses are keyed on (``seed``, the frame counter
        ``photo.frame``, the history); ``self.photo_sampler`` may be
        replaced by any ``ops.ransac.KeyedSampler``-style callable. The
        reference re-samples history frames stored as images by old
        checkpoints; the port stores sampled intensities only and has no
        such branch. Call after :meth:`setup_tracker`."""
        if not hasattr(self, "_img_hw"):
            raise RuntimeError("call setup_tracker first")
        if spatial and spatial_window < n_history:
            raise ValueError("spatial_window must hold one frame's rows of every history")
        h, w = self._img_hw
        self._photo_cfg = PhotoConfig(
            dims=calib.PhotoDims(n_history=n_history, n_obs=n_obs), epsilon_gap=epsilon_gap,
            epsilon_base=epsilon_base, cell_px=cell_px, n_cells_x=-(-w // cell_px),
            n_cells_y=-(-h // cell_px), spatial_every=spatial_every,
        )
        self.photo_sampler = KeyedSampler(int(seed), calib.N_HYPOTHESES, calib.SAMPLE_SIZE)
        self.photo = FacadePhoto.zero(self._photo_cfg, (h, w), n_obs * spatial_window if spatial else 0,
                                      self.params.tdtype, self.device)

    def _photometric_update(self, raw_img: torch.Tensor):
        """Update the gain chain from the tracked features' intensities in
        the raw frame against the history ring (the reference's
        ``ProcessCurrentFrame`` over several histories), append the spatial
        rows, push this frame into the ring (one program, captured once per
        number of real histories) and, when due, solve the spatial map (a
        second program; the gate reads the ring's valid rows on the host, as
        the reference's ``if`` does)."""
        cfg, ph = self._photo_cfg, self.photo
        n, fh = cfg.dims.n_obs, cfg.dims.n_history
        sp = ph.spatial
        ptr = 0 if sp is None else sp.ptr
        counters = self._upload((ph.frame, 1), (ptr, 1))[0]
        arrays, = self._run(
            "photo_frame", lambda arrays, n_hist, raw, pts, ids, c: photo_frame(
                cfg, self.photo_sampler, arrays, n_hist, raw, pts, ids, c),
            1, _photo_arrays(ph), ph.n_hist, raw_img, self._tracker_state.pts[0, :n],
            self._tracker_state.ids[0, :n], counters, static=(self.photo_sampler,))
        state, hist_int, hist_pts, hist_ids, ring = arrays
        k = ph.n_hist
        if sp is not None:
            sp = SpatialRing(*ring, ptr=(sp.ptr + k * n) % sp.valid.shape[0])
        ps = ph.ps
        frame = ph.frame + 1
        if sp is not None and frame % cfg.spatial_every == 0 and int(sp.valid.sum()) >= 20:
            ps, = self._run("spatial_solve", lambda ps, ring: spatial_solve(
                cfg, self._img_hw, ps, ring), 1, ps, ring)
        self.photo = FacadePhoto(state=state, hist_int=hist_int, hist_pts=hist_pts,
                                 hist_ids=hist_ids, n_hist=min(k + 1, fh), frame=frame,
                                 spatial=sp, ps=ps)

    def process_image_measurement(self, t: float, seq: int, img, ransac_idx=None):
        """Track features in the (H, W) image, then run the visual update.
        ``ransac_idx`` (1, S, 8) replaces the keyed RANSAC draws. With
        photometric calibration on, the tracker sees the corrected image and
        the gains update from the raw one."""
        from ..vision import tracker as trk_mod

        dt = self.params.tdtype
        if isinstance(img, torch.Tensor):
            img = img.to(self.device)
        else:
            img = torch.from_numpy(np.ascontiguousarray(img))
            img = (img.pin_memory().to(self.device, non_blocking=True)
                   if self.device.type == "cuda" else img)
        if self.photo is not None:
            linalg.require_fp32_matmul(self.device, "VIO.process_image_measurement")
            raw, cor = self._run("photo_correct", lambda state, ps, img: photo_correct(
                state, ps, img, dt), 0, self.photo.state, self.photo.ps, img)
        else:
            raw = cor = img.to(dt)
        if self.compiled:
            self._tracker_state, matches = self._tracker(self._tracker_state, cor[None],
                                                         self._seed, ransac_idx)
        else:
            self._tracker_state, matches = trk_mod.track_frame(
                self._tracker_params, self._camera, self._tracker_state, cor,
                seed=self._seed, ransac_idx=ransac_idx,
            )
        if self.photo is not None:
            self._photometric_update(raw)
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
        """The visual update from one frame's matches (agent axis of 1): one
        program (plain, debug or collaborative), then one host read of its
        report (``applied``, the keyframe step, the health monitor's
        values)."""
        linalg.require_fp32_matmul(self.device, "VIO.process_matches_measurement")
        if self._health is not None:
            # tracking-quality gate: starved frames are withheld from the filter
            if int(matches.valid.sum()) < self._health["min_matches"]:
                self._last_matches = matches
                self._health_post_update(False)
                return False
        rng, sun = (0.0, np.zeros(2), 0.0), (np.zeros(2), 0.0)
        if self._last_range is not None:
            rng = (self._last_range[0], self._last_range[1], 1.0)
            self._last_range = None
        if self._last_sun is not None:
            sun = (self._last_sun, 1.0)
            self._last_sun = None
        x = self._upload((t, 1), (rng[0], 1), (rng[1], 2), (rng[2], 1), (sun[0], 2), (sun[1], 1))
        self._last_matches = matches
        params = self.params
        dbg = None
        if self._collab_enabled:
            from ..parallel import collab as collab_mod

            ccfg, db_dims = self._ccfg, self._db_dims
            (self.fs, self.slots, self._store, self._db, self._kf_meta, report,
             n_collab) = self._run(
                "process_matches_collab",
                lambda fs, slots, store, db, kf_meta, words, x, m: collab_mod.match_update_collab(
                    params, ccfg, db_dims, fs, slots, store, db, kf_meta, words, x, m),
                5, self.fs, self.slots, self._store, self._db, self._kf_meta, self._words, x,
                matches)
            self.n_collab_consumed = self.n_collab_consumed + n_collab[0]
        elif self._debug:
            self.fs, self.slots, report, dbg = self._run(
                "process_matches_debug",
                lambda fs, slots, x, m: match_update_debug(params, fs, slots, x, m),
                2, self.fs, self.slots, x, matches)
        else:
            self.fs, self.slots, report = self._run(
                "process_matches", lambda fs, slots, x, m: match_update(params, fs, slots, x, m),
                2, self.fs, self.slots, x, matches)
        report = report[0].tolist()  # the one host read after the update
        applied = bool(report[0])
        if self._collab_enabled:
            self.n_keyframes_selected += int(report[3])
        if applied and dbg is not None:  # dropped updates keep the last real payload
            self.last_debug = tree.map_leaves(torch.clone, dbg)
        if self._health is not None:
            self._health_post_update(applied, report)
        return applied

    # -- multi-agent collaboration (request-response) ---------------------------

    def enable_collab(self, words, uav_id: int = 0, db_dims=None, ccfg=None, store_dims=None,
                      seed: int = 0):
        """Attach the collaborative stack: keyframe ring with VLAD
        vocabulary ``words`` (W, 32) and a persistent cross-agent match
        store. After this every applied visual update runs the
        keyframe-selection heuristic and consumes stored matches.
        The RANSAC gates' hypotheses are keyed on (``seed``, the gate's
        salt, the payload time, the receiver's buffer head or the sender's
        id); ``self.sampler`` may be replaced by any
        ``ops.ransac.KeyedSampler``-style callable."""
        from ..parallel import collab as collab_mod, match_store as ms_mod
        from ..place_recognition import database as db_mod

        if self.fs is None:
            raise RuntimeError("call init_at_time first")
        self._words = torch.as_tensor(words, dtype=torch.uint8, device=self.device)
        self._uav_id = int(uav_id)
        self._db_dims = db_dims or db_mod.DbDims(n_words=int(self._words.shape[0]))
        self._ccfg = ccfg or collab_mod.CollabConfig()
        self._store_dims = store_dims or ms_mod.StoreDims()
        self.sampler = KeyedSampler(int(seed))
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
        params, ccfg = self.params, self._ccfg
        x = self._upload((uav_id, 1), (bool(valid), 1))
        self.fs, self.slots, self._store, n, recency1 = self._run(
            "receive_and_record",
            lambda fs, slots, store, payload, x, rec: collab_mod.receive_and_record_packed(
                params, ccfg, fs, slots, store, payload, x, rec, self.sampler),
            3, self.fs, self.slots, self._store, payload, x, recency, static=(self.sampler,))
        if recency is not None:  # the program's outputs: kept past its next call
            last_id, last_cnt, cnt = recency1
            self._fuse_recency[uav_id] = (last_id.clone(), last_cnt.clone(), cnt + 1)
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

    def render_debug_image(self, img, camera=None) -> np.ndarray:
        """RGB uint8 feature-class plot of the last update's debug payload
        over ``img`` (the reference's track-manager plot); the plain image
        without ``debug=True`` or before the first applied update."""
        from ..utils import render

        if self.last_debug is None:
            return render.to_rgb(img)
        return render.draw_track_classes(img, self.last_debug, camera)


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
