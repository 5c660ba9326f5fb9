"""Shared geometry for visual update Jacobians (port of
``x_multi_agent_tpu.vio.updates.common``).

Window arrays store camera poses: ``q_wc`` is the world<-camera attitude
(xyzw), ``p_wc`` the camera position in world.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class UpdateRows(NamedTuple):
    """One update constructor's contribution to the stacked system. Masked
    rows are identically zero in jac AND res (noise_std stays positive)."""

    jac: torch.Tensor  # (A, rows, D)
    res: torch.Tensor  # (A, rows)
    noise_std: torch.Tensor  # (A, rows)


def projection_blocks(pt_cam: torch.Tensor):
    """J_i = d(projection)/d(camera-frame point) (..., 2, 3), guarding z ~ 0.
    Returns (J_i, predicted (x/z, y/z), finite-mask)."""
    z = pt_cam[..., 2]
    ok = torch.isfinite(pt_cam).all(-1) & (torch.abs(z) > 1e-12)
    zs = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    inv_z = 1.0 / zs
    pred = pt_cam[..., :2] * inv_z[..., None]
    zero = torch.zeros_like(z)
    j_i = torch.stack(
        [
            torch.stack([inv_z, zero, -pt_cam[..., 0] * inv_z * inv_z], -1),
            torch.stack([zero, inv_z, -pt_cam[..., 1] * inv_z * inv_z], -1),
        ],
        dim=-2,
    )
    return j_i, pred, ok


def oc_project(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Observability-constrained projection A - A u (u^T u)^-1 u^T (Hesch et
    al. 2012); a (..., r, 3), u (..., 3)."""
    denom = torch.sum(u * u, dim=-1)
    safe = torch.where(denom > 1e-12, denom, torch.ones_like(denom))
    au = (a @ u[..., None])[..., 0]
    return a - (au[..., :, None] * u[..., None, :]) / safe[..., None, None]


def scatter_block(h: torch.Tensor, block: torch.Tensor, col) -> torch.Tensor:
    """Add (..., rows, 3) ``block`` into the (..., rows, D) Jacobian ``h`` at
    column offset ``col`` (int or (...) tensor), as a one-hot selector
    matmul."""
    d = h.shape[-1]
    cols = torch.arange(d, device=h.device)
    if isinstance(col, torch.Tensor):
        tgt = col[..., None] + torch.arange(3, device=h.device)
    else:
        tgt = torch.arange(col, col + 3, device=h.device)
    sel = (cols == tgt[..., None]).to(h.dtype)  # (..., 3, D)
    return h + block @ sel


def pose_pos_col(pose_idx, n_poses: int):
    return 15 + 3 * pose_idx


def pose_att_col(pose_idx, n_poses: int):
    return 15 + 3 * n_poses + 3 * pose_idx


def feature_col(feat_idx, n_poses: int):
    return 15 + 6 * n_poses + 3 * feat_idx
