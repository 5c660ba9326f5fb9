"""The VIO entry functions: the parameter set, the initial covariance,
``init_at_time``, the match-driven ``process_matches`` (and its debug form),
and the packed per-frame row of the match update."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve
from ..ekf import ekf as ekf_mod
from ..ekf.propagator import ImuNoise
from ..ekf.state import CoreState, FilterState, VisionState
from ..ops import lie
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
