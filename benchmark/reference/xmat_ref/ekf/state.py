"""Filter state containers (port of ``x_multi_agent_tpu.ekf.state``).

Error-state vector layout, total dim D = 15 + 6M + 3N:

    [ dp(3) dv(3) dtheta(3) db_w(3) db_a(3) |
      dp_arr(3M) | dtheta_arr(3M) | df_arr(3N) ]

Every tensor carries a leading agent axis A (a "scalar" field is (A,)).
Covariance propagation is lazy, as in the reference: a small CoreState per
IMU sample lives in a ring buffer, and the (D, D) covariance is anchored at
the last update and propagated by compounded transitions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import resolve
from ..ops import lie


class StateDims(NamedTuple):
    """Static filter dimensions."""

    n_poses: int = 15  # M: sliding-window camera pose clones
    n_features: int = 15  # N: persistent SLAM features (inverse depth)
    buffer_size: int = 250  # B: IMU-rate ring buffer depth

    @property
    def d(self) -> int:
        """Error-state dimension 15 + 6M + 3N."""
        return 15 + 6 * self.n_poses + 3 * self.n_features

    @property
    def idx_p_arr(self) -> int:
        return 15

    @property
    def idx_q_arr(self) -> int:
        return 15 + 3 * self.n_poses

    @property
    def idx_f_arr(self) -> int:
        return 15 + 6 * self.n_poses


def _i32(a, value, device):
    return torch.full((a,), value, dtype=torch.int32, device=device)


@dataclass(frozen=True)
class CoreState:
    """IMU-rate state (leading dims: agents, and ring slots where stacked)."""

    time: torch.Tensor  # (...,); < 0 means invalid
    seq: torch.Tensor  # (...,) int32
    p: torch.Tensor  # (..., 3)
    v: torch.Tensor  # (..., 3)
    q: torch.Tensor  # (..., 4) xyzw, world<-body
    b_w: torch.Tensor  # (..., 3)
    b_a: torch.Tensor  # (..., 3)
    w_m: torch.Tensor  # (..., 3) gyro measurement at `time`
    a_m: torch.Tensor  # (..., 3) accel measurement at `time`

    @staticmethod
    def zero(a: int, dtype=torch.float32, device=None) -> "CoreState":
        device = resolve(device)
        z3 = torch.zeros((a, 3), dtype=dtype, device=device)
        return CoreState(
            time=torch.full((a,), -1.0, dtype=dtype, device=device),
            seq=_i32(a, -1, device),
            p=z3, v=z3,
            q=lie.quat_identity(dtype, device).expand(a, 4).clone(),
            b_w=z3, b_a=z3, w_m=z3, a_m=z3,
        )


@dataclass(frozen=True)
class VisionState:
    """Sliding-window + SLAM-feature states, anchored at the last update.

    ``anchor_idx[j]`` is the window index of feature j's inverse-depth
    anchor pose (-1: inactive slot). The window is right-aligned: the newest
    pose sits at slot M-1 and valid poses occupy [M - n_valid, M)."""

    p_arr: torch.Tensor  # (A, M, 3) camera positions in world
    q_arr: torch.Tensor  # (A, M, 4) camera attitudes xyzw (world<-cam)
    f_arr: torch.Tensor  # (A, N, 3) inverse-depth (alpha, beta, rho)
    anchor_idx: torch.Tensor  # (A, N) int32
    n_valid_poses: torch.Tensor  # (A,) int32
    n_valid_features: torch.Tensor  # (A,) int32

    @staticmethod
    def zero(dims: StateDims, a: int, dtype=torch.float32, device=None) -> "VisionState":
        m, n = dims.n_poses, dims.n_features
        device = resolve(device)
        return VisionState(
            p_arr=torch.zeros((a, m, 3), dtype=dtype, device=device),
            # empty slots hold identity quaternions: correct() renormalizes
            # every slot, and a zero quaternion would produce NaN there
            q_arr=lie.quat_identity(dtype, device).expand(a, m, 4).clone(),
            f_arr=torch.zeros((a, n, 3), dtype=dtype, device=device),
            anchor_idx=torch.full((a, n), -1, dtype=torch.int32, device=device),
            n_valid_poses=_i32(a, 0, device),
            n_valid_features=_i32(a, 0, device),
        )

    def pose_mask(self, dims: StateDims) -> torch.Tensor:
        m = dims.n_poses
        return torch.arange(m, device=self.p_arr.device) >= m - self.n_valid_poses[:, None]

    def feature_mask(self, dims: StateDims) -> torch.Tensor:
        n = dims.n_features
        return torch.arange(n, device=self.p_arr.device) < self.n_valid_features[:, None]


@dataclass(frozen=True)
class FilterState:
    """Full filter: IMU ring buffer + update-anchored vision state/covariance."""

    buffer: torch.Tensor  # (A, B, 24) packed CoreState rows (see ekf/buffer.py)
    head: torch.Tensor  # (A,) int32: ring index of newest entry
    size: torch.Tensor  # (A,) int32: number of valid entries (<= B)
    anchor_buf_idx: torch.Tensor  # (A,) int32: ring index the covariance is anchored at
    cov: torch.Tensor  # (A, D, D) error covariance at the anchor time
    vision: VisionState
    status: torch.Tensor  # (A,) int32: 0 not initialized / 1 standby / 2 initialized
    n_spikes: torch.Tensor  # (A,) int32: accel spikes rejected so far
    n_seq_gaps: torch.Tensor  # (A,) int32: missing IMU messages detected so far

    @staticmethod
    def zero(dims: StateDims, a: int, dtype=torch.float32, device=None) -> "FilterState":
        from . import buffer as _rb

        device = resolve(device)
        return FilterState(
            buffer=_rb.empty_buffer(a, dims.buffer_size, dtype, device),
            head=_i32(a, 0, device),
            size=_i32(a, 0, device),
            anchor_buf_idx=_i32(a, 0, device),
            cov=torch.zeros((a, dims.d, dims.d), dtype=dtype, device=device),
            vision=VisionState.zero(dims, a, dtype, device),
            status=_i32(a, 0, device),
            n_spikes=_i32(a, 0, device),
            n_seq_gaps=_i32(a, 0, device),
        )


# ---------------------------------------------------------------------------
# state correction
# ---------------------------------------------------------------------------


def correct_core(core: CoreState, correction: torch.Tensor) -> CoreState:
    """Apply the first 15 error-state entries: additive for p, v, b_w, b_a;
    right-multiplicative error quaternion for q."""
    dq = lie.error_quat_from_small_angles(correction[..., 6:9])
    return dataclasses.replace(
        core,
        p=core.p + correction[..., 0:3],
        v=core.v + correction[..., 3:6],
        q=lie.quat_normalize(lie.quat_multiply(core.q, dq)),
        b_w=core.b_w + correction[..., 9:12],
        b_a=core.b_a + correction[..., 12:15],
    )


def correct_vision(vision: VisionState, correction: torch.Tensor, dims: StateDims) -> VisionState:
    """Apply window/feature error-state entries."""
    m, n = dims.n_poses, dims.n_features
    lead = correction.shape[:-1]
    dp_arr = correction[..., dims.idx_p_arr : dims.idx_p_arr + 3 * m].reshape(lead + (m, 3))
    dth_arr = correction[..., dims.idx_q_arr : dims.idx_q_arr + 3 * m].reshape(lead + (m, 3))
    df_arr = correction[..., dims.idx_f_arr : dims.idx_f_arr + 3 * n].reshape(lead + (n, 3))
    dq_arr = lie.error_quat_from_small_angles(dth_arr)
    return dataclasses.replace(
        vision,
        p_arr=vision.p_arr + dp_arr,
        q_arr=lie.quat_normalize(lie.quat_multiply(vision.q_arr, dq_arr)),
        f_arr=vision.f_arr + df_arr,
    )


# ---------------------------------------------------------------------------
# camera pose composition
# ---------------------------------------------------------------------------


def camera_orientation(core: CoreState, q_ic: torch.Tensor) -> torch.Tensor:
    return lie.quat_normalize(lie.quat_multiply(core.q, q_ic))


def camera_position(core: CoreState, p_ic: torch.Tensor) -> torch.Tensor:
    return core.p + torch.matmul(lie.quat_to_rot(core.q), p_ic)
