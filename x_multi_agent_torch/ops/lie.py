"""Quaternion / SO(3) primitives (port of ``x_multi_agent_tpu.ops.lie``).

Quaternions are stored (x, y, z, w), Hamilton product, unit norm. Every
function is polymorphic over leading batch dimensions and dtype.
"""
from __future__ import annotations

import torch

from ..device import resolve
from ..utils.const import constant


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity (0, 0, 0, 1), built once per (dtype, device): do not
    write into it."""
    return constant((0.0, 0.0, 0.0, 1.0), dtype, resolve(device))


def quat_multiply(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ p, both xyzw, broadcastable."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
            qw * pw - qx * px - qy * py - qz * pz,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * constant((-1.0, -1.0, -1.0, 1.0), q.dtype, q.device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a unit xyzw quaternion (Eigen ``toRotationMatrix``)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Shepperd's method, branch-free; returns xyzw with w >= 0."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1 + tr], dim=-1)
    qx0 = torch.stack([1 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    qy0 = torch.stack([m01 + m10, 1 - m00 + m11 - m22, m12 + m21, m02 - m20], dim=-1)
    qz0 = torch.stack([m02 + m20, m12 + m21, 1 - m00 - m11 + m22, m10 - m01], dim=-1)
    scores = torch.stack(
        [1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(scores, dim=-1)[..., None]
    q = torch.where(
        best == 0, qw0, torch.where(best == 1, qx0, torch.where(best == 2, qy0, qz0))
    )
    q = quat_normalize(q)
    return torch.where(q[..., 3:4] < 0, -q, q)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def omega_matrix(w: torch.Tensor) -> torch.Tensor:
    """Angular rate -> 4x4 quaternion differentiation matrix (Trawny eq. 108,
    xyzw order): q_dot = 0.5 * Omega(w) @ q."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack(
        [
            zero, z, -y, x,
            -z, zero, x, y,
            y, -x, zero, z,
            -x, -y, -z, zero,
        ],
        dim=-1,
    )
    return m.reshape(w.shape[:-1] + (4, 4))


def error_quat_from_small_angles(dtheta: torch.Tensor) -> torch.Tensor:
    """Exact angle-axis error quaternion, Taylor-guarded sinc near 0."""
    a2 = torch.sum(dtheta * dtheta, dim=-1, keepdim=True)
    a = torch.sqrt(a2)
    small = a2 < 1e-12
    safe_a = torch.where(small, torch.ones_like(a), a)
    s = torch.where(small, 0.5 - a2 / 48.0, torch.sin(safe_a * 0.5) / safe_a)
    return torch.cat([dtheta * s, torch.cos(a * 0.5)], dim=-1)


def small_angles_from_error_quat(dq: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`error_quat_from_small_angles`."""
    v = dq[..., :3]
    w = dq[..., 3:4]
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(n, w)
    small = n < 1e-12
    safe_n = torch.where(small, torch.ones_like(n), n)
    return torch.where(small, 2.0 * v, v / safe_n * angle)
