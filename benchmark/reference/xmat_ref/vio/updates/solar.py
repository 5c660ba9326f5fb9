"""Sun-sensor angle update (port of ``x_multi_agent_tpu.vio.updates.solar``):
a 2-dof sun-angle residual against the IMU attitude, no chi2 gate."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ...ops import lie
from ...utils.const import constant
from .common import UpdateRows

RAD2DEG = 57.2957795130


class SolarCalib(NamedTuple):
    q_si: Tuple[float, float, float, float] = (
        0.360346005598587,
        -0.063338979194957,
        0.007502445522018,
        0.930635612981541,
    )  # sun sensor <- IMU, xyzw
    sun_w: Tuple[float, float, float] = (
        -0.29385515271891938,
        -0.55080445540063927,
        0.78119370269565391,
    )  # sun direction in world (normalized below)
    var_sun_angle: float = 10000 * 0.01777777777  # [deg^2]


def build(
    angles: torch.Tensor,  # (A, 2) measured sun angles [deg]
    q_imu: torch.Tensor,  # (A, 4) current IMU attitude (world<-body)
    cov: torch.Tensor,  # (A, D, D)
    active: torch.Tensor,  # (A,)
    calib: SolarCalib = SolarCalib(),
) -> UpdateRows:
    a, d = cov.shape[0], cov.shape[-1]
    dtype, dev = cov.dtype, cov.device
    sun_w = constant(tuple(calib.sun_w), dtype, dev)
    sun_w = sun_w / torch.linalg.norm(sun_w)
    r_is = lie.quat_to_rot(constant(tuple(calib.q_si), dtype, dev)).T
    sun_b = (lie.quat_to_rot(q_imu).transpose(-1, -2) @ sun_w)  # (A, 3)
    s_sun = sun_b @ r_is.T
    s_sun = s_sun / torch.linalg.norm(s_sun, dim=-1, keepdim=True)
    sx, sy, sz = s_sun[:, 0], s_sun[:, 1], s_sun[:, 2]
    pred = RAD2DEG * torch.stack([torch.atan2(sx, sz), torch.atan2(sy, sz)], dim=-1)
    res = angles.to(dtype) - pred

    den0 = sx**2 + sz**2
    den1 = sy**2 + sz**2
    zero = torch.zeros_like(sx)
    mat = torch.stack([
        torch.stack([sz / den0, zero, -sx / den0], -1),
        torch.stack([zero, sz / den1, -sy / den1], -1),
    ], dim=-2)  # (A, 2, 3)
    j_att = RAD2DEG * mat @ r_is @ lie.skew(sun_b)
    h = torch.zeros((a, 2, d), dtype=dtype, device=dev)
    h[:, :, 6:9] = j_att

    sigma = torch.sqrt(torch.full((a, 2), calib.var_sun_angle, dtype=dtype, device=dev))
    keep = (active & torch.isfinite(res).all(-1))[:, None]
    return UpdateRows(torch.where(keep[..., None], h, 0.0), torch.where(keep, res, 0.0), sigma)
