"""MSCKF-SLAM hybrid update, Li 2012 (port of
``x_multi_agent_tpu.vio.updates.msckf_slam``).

Like the MSCKF update, but the feature is about to be initialized into the
state anchored at the current (last) pose: the last observation's rows carry
only Hf = [[1,0,0],[0,1,0]] and every other observation also carries
anchor-pose Jacobians. Alongside the nullspace-projected rows it returns the
column-space projections H1 = U^T H, H2 = U^T Hf, r1 = U^T res used for
in-update feature initialization. No OC projection (as the reference).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import lie, linalg, triangulation
from ...utils.chi2 import chi2_gate
from .common import UpdateRows, projection_blocks
from .msckf import _assemble_h


class MsckfSlamInit(NamedTuple):
    """Per-track feature-initialization matrices."""

    h1: torch.Tensor  # (A, K, 3, D)
    h2: torch.Tensor  # (A, K, 3, 3)
    r1: torch.Tensor  # (A, K, 3)
    features: torch.Tensor  # (A, K, 3) triangulated inverse depth (anchor = cur pose)
    inlier: torch.Tensor  # (A, K)
    world: torch.Tensor  # (A, K, 3)
    anchor: torch.Tensor  # (A, K) anchor window index


def _inv_depth_jac(alpha, beta, safe_rho):
    """(..., 3, 3) [[1, 0, -a/rho], [0, 1, -b/rho], [0, 0, -1/rho]]."""
    one, zero = torch.ones_like(alpha), torch.zeros_like(alpha)
    return torch.stack([
        torch.stack([one, zero, -alpha / safe_rho], -1),
        torch.stack([zero, one, -beta / safe_rho], -1),
        torch.stack([zero, zero, -1.0 / safe_rho], -1),
    ], dim=-2)


def build(
    obs: torch.Tensor,  # (A, K, M, 2)
    mask: torch.Tensor,  # (A, K, M) — last valid obs must be the current pose
    q_arr: torch.Tensor,
    p_arr: torch.Tensor,
    cov: torch.Tensor,
    sigma_img: float,
    n_features: int,
    max_iter: int = 10,
    term: float = 1e-5,
    fixed_tri=None,
):
    """``fixed_tri`` = (ivd (A,K,3), anchor (A,K)): reuse a previous
    triangulation (required for IEKF iterations > 0)."""
    a, k, m, _ = obs.shape
    dtype, dev = cov.dtype, cov.device
    d = cov.shape[-1]

    n_obs = torch.sum(mask, dim=-1)
    enough = n_obs >= 2
    if fixed_tri is None:
        ivd, anchor = triangulation.triangulate_gn(obs, mask, q_arr, p_arr, max_iter, term)
    else:
        ivd, anchor = fixed_tri
    alpha, beta, rho = ivd[..., 0], ivd[..., 1], ivd[..., 2]
    safe_rho = torch.where(torch.abs(rho) > 1e-12, rho, torch.ones_like(rho))
    ar = torch.arange(a, device=dev)[:, None]
    q_a = q_arr[ar, anchor.long()]
    p_a = p_arr[ar, anchor.long()]
    r_wa = lie.quat_to_rot(q_a)  # (A, K, 3, 3)
    bearing = torch.stack([alpha, beta, torch.ones_like(alpha)], dim=-1)
    g_p_f = (r_wa @ bearing[..., None])[..., 0] / safe_rho[..., None] + p_a

    r_cw = lie.quat_to_rot(q_arr)[:, None].transpose(-1, -2)  # (A, 1, M, 3, 3)
    is_last = torch.arange(m, device=dev) == anchor[..., None]  # (A, K, M)
    pt_cam = (r_cw @ (g_p_f[:, :, None] - p_arr[:, None])[..., None])[..., 0]
    j_i, pred, ok = projection_blocks(pt_cam)
    res = obs - pred
    j_pos = -j_i @ r_cw
    j_att = j_i @ lie.skew(pt_cam)
    r_wa_o = r_wa[:, :, None]
    rho_o = safe_rho[..., None, None, None]
    j_anchor_att = -1.0 / rho_o * j_i @ r_cw @ r_wa_o @ lie.skew(bearing)[:, :, None]
    j_anchor_pos = -j_pos
    mat = _inv_depth_jac(alpha, beta, safe_rho)[:, :, None]
    hf = (1.0 / rho_o) * j_i @ r_cw @ r_wa_o @ mat

    # last obs: only Hf = [[1,0,0],[0,1,0]]; no pose/anchor blocks
    hf_last = torch.eye(3, dtype=dtype, device=dev)[:2]
    last = is_last[..., None, None]
    j_pos = torch.where(last, 0.0, j_pos)
    j_att = torch.where(last, 0.0, j_att)
    j_anchor_pos = torch.where(last, 0.0, j_anchor_pos)
    j_anchor_att = torch.where(last, 0.0, j_anchor_att)
    hf = torch.where(last, hf_last, hf)
    keep = mask[..., None, None]
    res = torch.where(mask[..., None], res, 0.0)
    j_pos, j_att, j_anchor_pos, j_anchor_att, hf = (
        torch.where(keep, x, 0.0) for x in (j_pos, j_att, j_anchor_pos, j_anchor_att, hf)
    )
    finite = (ok | ~mask).all(-1)

    anchor_onehot = is_last.to(dtype)
    h = _assemble_h(j_pos, j_att, m, n_features, j_anchor_pos, j_anchor_att, anchor_onehot)
    h0, res0, h1, (r1, h2) = linalg.nullspace_project(
        hf.reshape(a, k, 2 * m, 3), h, res.reshape(a, k, 2 * m)
    )
    gamma = linalg.mahalanobis_gamma(cov[:, None], h0 / sigma_img, res0 / sigma_img)
    inlier = (chi2_gate(gamma, 2 * n_obs - 3, 0.95, 2 * m) & enough & finite
              & torch.isfinite(gamma))
    h0 = torch.where(inlier[..., None, None], h0, 0.0)
    res0 = torch.where(inlier[..., None], res0, 0.0)

    rows = k * (2 * m - 3)
    update = UpdateRows(
        jac=h0.reshape(a, rows, d),
        res=res0.reshape(a, rows),
        noise_std=torch.full((a, rows), sigma_img, dtype=dtype, device=dev),
    )
    init = MsckfSlamInit(
        h1=h1, h2=h2, r1=r1, features=ivd, inlier=inlier, world=g_p_f, anchor=anchor,
    )
    return update, init
