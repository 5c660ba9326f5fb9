"""Batched inverse-depth triangulation (port of
``x_multi_agent_tpu.ops.triangulation``).

Two-view DLT initialization (first/last valid observation, closed-form 3x3
normal equations) followed by Gauss-Newton refinement over all observations
in (alpha, beta, rho) anchored at the last valid observation frame. Tracks
occupy window-aligned (M,) slots with a validity mask; invalid observations
contribute zero residual rows.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import lie
from .linalg import solve3


def _proj(rot_cw: torch.Tensor, pos_wc: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) projection [R_cw | -R_cw p]."""
    return torch.cat([rot_cw, -(rot_cw @ pos_wc[..., None])], dim=-1)


def triangulate_dlt(obs1, obs2, proj1, proj2) -> torch.Tensor:
    """Two-view linear triangulation (inhomogeneous, w = 1); world xyz."""
    rows = torch.stack(
        [
            obs1[..., 0, None] * proj1[..., 2, :] - proj1[..., 0, :],
            obs1[..., 1, None] * proj1[..., 2, :] - proj1[..., 1, :],
            obs2[..., 0, None] * proj2[..., 2, :] - proj2[..., 0, :],
            obs2[..., 1, None] * proj2[..., 2, :] - proj2[..., 1, :],
        ],
        dim=-2,
    )
    a = rows[..., :3]
    b = -rows[..., 3]
    eye = torch.eye(3, dtype=rows.dtype, device=rows.device)
    ata = a.transpose(-1, -2) @ a + 1e-12 * eye
    return solve3(ata, (a.transpose(-1, -2) @ b[..., None])[..., 0])


def triangulate_gn(
    obs: torch.Tensor,  # (A, K, M, 2) normalized image coords, window-aligned
    mask: torch.Tensor,  # (A, K, M) bool
    q_wc: torch.Tensor,  # (A, M, 4) camera attitudes xyzw (world<-cam)
    p_wc: torch.Tensor,  # (A, M, 3) camera positions in world
    max_iter: int = 10,
    term: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-depth triangulation of K tracks per agent. Returns
    ((alpha, beta, rho) (A, K, 3) anchored at the last valid observation
    pose, anchor window index (A, K))."""
    m = obs.shape[-2]
    dtype, dev = obs.dtype, obs.device
    mk = mask.to(torch.uint8)
    i1 = torch.argmax(mk, dim=-1)  # first True
    i2 = m - 1 - torch.argmax(mk.flip(-1), dim=-1)  # last True

    rot_cw = lie.quat_to_rot(q_wc).transpose(-1, -2)  # (A, M, 3, 3) world->cam
    a = obs.shape[0]
    ar = torch.arange(a, device=dev)[:, None]
    rot1, rot_a = rot_cw[ar, i1], rot_cw[ar, i2]  # (A, K, 3, 3)
    p1, p_a = p_wc[ar, i1], p_wc[ar, i2]
    obs1 = torch.gather(obs, 2, i1[..., None, None].expand(-1, -1, 1, 2))[:, :, 0]
    obs2 = torch.gather(obs, 2, i2[..., None, None].expand(-1, -1, 1, 2))[:, :, 0]
    pt_w = triangulate_dlt(obs1, obs2, _proj(rot1, p1), _proj(rot_a, p_a))

    pt_a = (rot_a @ (pt_w - p_a)[..., None])[..., 0]
    z = pt_a[..., 2]
    params = torch.stack([pt_a[..., 0] / z, pt_a[..., 1] / z, 1.0 / z], dim=-1)

    # per-frame relative transforms to the anchor: R_i R_a^T, R_i (p_a - p_i)
    delta_rot = torch.einsum("amij,aklj->akmil", rot_cw, rot_a)  # (A, K, M, 3, 3)
    delta_pos = torch.einsum("amij,akmj->akmi", rot_cw, p_a[:, :, None] - p_wc[:, None])
    eps = 1e-12 if dtype == torch.float64 else 1e-8
    eye = torch.eye(3, dtype=dtype, device=dev)

    # loop-invariant Jacobian basis [j_alpha, j_beta, j_rho], premasked
    j0 = torch.cat([delta_rot[..., 0:2], delta_pos[..., None]], dim=-1)
    j0 = torch.where(mask[..., None, None], j0, 0.0)

    r_norm_last = torch.full_like(z, 1000.0)
    r_norm = torch.full_like(z, 100.0)
    active = torch.ones_like(mask[..., 0])
    ones = torch.ones_like(z)
    for _ in range(max_iter):
        bearing = torch.stack([params[..., 0], params[..., 1], ones], dim=-1)
        h_i = (torch.einsum("akmij,akj->akmi", delta_rot, bearing)
               + params[..., 2, None, None] * delta_pos)
        z_i = h_i[..., 2]
        safe_z = torch.where(torch.abs(z_i) < eps, torch.ones_like(z_i), z_i)
        pred = h_i[..., :2] / safe_z[..., None]
        r = torch.where(mask[..., None], obs - pred, 0.0)  # (A, K, M, 2)
        inv_z = 1.0 / safe_z
        jac = (
            -inv_z[..., None, None] * j0[..., :2, :]
            + (h_i[..., :2] * (inv_z * inv_z)[..., None])[..., None] * j0[..., 2:3, :]
        )
        jtj = torch.einsum("akmij,akmil->akjl", jac, jac)
        jtr = torch.einsum("akmij,akmi->akj", jac, r)
        delta = solve3(jtj + eps * eye, jtr)
        new_r_norm = torch.sqrt(torch.sum(r * r, dim=(-2, -1)))
        # termination (reference: while r_norm_last - r_norm > term)
        active = active & (r_norm_last - r_norm > term)
        params = torch.where(active[..., None], params - delta, params)
        r_norm_last, r_norm = r_norm, new_r_norm
    return params, i2.to(torch.int32)


def ivd_to_world(ivd: torch.Tensor, q_wc_anchor: torch.Tensor, p_wc_anchor: torch.Tensor):
    """(alpha, beta, rho) in the anchor frame -> world point (..., 3)."""
    bearing = torch.stack([ivd[..., 0], ivd[..., 1], torch.ones_like(ivd[..., 0])], dim=-1)
    rot = lie.quat_to_rot(q_wc_anchor)
    return (rot @ bearing[..., None])[..., 0] / ivd[..., 2, None] + p_wc_anchor
