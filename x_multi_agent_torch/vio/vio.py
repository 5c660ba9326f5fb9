"""VIO entry functions (port of the module-level part of
``x_multi_agent_tpu.vio.vio``): the parameter set, the initial covariance,
``init_at_time`` and the match-driven ``process_matches``. The stateful
``VIO`` facade class is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

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
    b_w=None, b_a=None,
) -> Tuple[FilterState, tm.TrackSlots]:
    """Zero vision state, sigma-diagonal covariance, standby until the first
    IMU sample — for ``n_agents`` agents that start from the same state."""
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
    fs = ekf_mod.init_from_state(params.ekf_params, core, VisionState.zero(dims, a, dt, device), cov0)
    return fs, tm.TrackSlots.zero(params.cfg.tracks, a, dt, device)


def process_matches(params: VioParams, fs, slots, meas_time, meas: pipeline.FrameMeasurement):
    """Visual update driven by a match list (per agent). Returns
    (fs, slots, applied (A,))."""

    def update_fn(core, vision, cov, slots):
        return pipeline.visual_update(params.cfg, core, vision, cov, slots, meas)

    return ekf_mod.process_update_aux_impl(params.ekf_params, fs, meas_time, update_fn, slots)
