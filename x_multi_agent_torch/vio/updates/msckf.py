"""MSCKF update: opportunistic tracks marginalized via nullspace projection
(port of ``x_multi_agent_tpu.vio.updates.msckf``).

Per track: residual + pose Jacobians of every observation (with the
observability-constrained gravity-nullspace projection, Hesch et al. 2012),
left-nullspace projection of the feature Jacobian, chi2(2m - 3, 0.95) gate.
Each of the K tracks per agent contributes 2M-3 (padded) rows; gated or
invalid tracks contribute zero rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import lie, linalg, triangulation
from ...utils.chi2 import chi2_gate
from ...utils.const import constant
from .common import UpdateRows, oc_project, projection_blocks

GRAVITY = (0.0, 0.0, -9.81)


class MsckfTrackInfo(NamedTuple):
    ivd: torch.Tensor  # (A, K, 3) triangulated inverse depth (anchor = last obs)
    anchor: torch.Tensor  # (A, K) anchor window index
    world: torch.Tensor  # (A, K, 3) triangulated world points
    inlier: torch.Tensor  # (A, K) passed the chi2 gate
    valid: torch.Tensor  # (A, K) had enough observations + finite math


def _obs_jacobians(g_p_f, obs, mask, q_arr, p_arr, g_vec, oc: bool):
    """Per-observation residuals and (position, attitude, feature) blocks.
    g_p_f (A, K, 3); obs (A, K, M, 2); q_arr/p_arr (A, M, .). Returns res
    (A,K,M,2), j_pos, j_att, hf (A,K,M,2,3), finite (A,K)."""
    r_wc = lie.quat_to_rot(q_arr)[:, None]  # (A, 1, M, 3, 3)
    r_cw = r_wc.transpose(-1, -2)
    diff = g_p_f[:, :, None] - p_arr[:, None]  # (A, K, M, 3)
    pt_cam = (r_cw @ diff[..., None])[..., 0]
    j_i, pred, ok = projection_blocks(pt_cam)
    res = obs - pred
    j_pos = -j_i @ r_cw
    j_att = j_i @ lie.skew(pt_cam)
    if oc:
        u_pos = (r_wc @ g_vec[:, None])[..., 0]
        u_att = (lie.skew(diff) @ g_vec[:, None])[..., 0]
        j_pos = oc_project(j_pos, u_pos)
        j_att = oc_project(j_att, u_att)
    hf = -j_pos
    keep = mask[..., None]
    res = torch.where(keep, res, 0.0)
    keep = keep[..., None]
    return (
        res,
        torch.where(keep, j_pos, 0.0),
        torch.where(keep, j_att, 0.0),
        torch.where(keep, hf, 0.0),
        (ok | ~mask).all(-1),
    )


def _assemble_h(j_pos, j_att, m: int, n: int, anchor_pos=None, anchor_att=None,
                anchor_onehot=None):
    """Scatter per-obs (A, K, M, 2, 3) blocks into (A, K, 2M, D) at their
    own window-slot columns (plus, optionally, anchor-slot blocks)."""
    dtype, dev = j_pos.dtype, j_pos.device
    eye_m = torch.eye(m, dtype=dtype, device=dev)
    pos_big = torch.einsum("zkmab,mn->zkmanb", j_pos, eye_m)
    att_big = torch.einsum("zkmab,mn->zkmanb", j_att, eye_m)
    if anchor_onehot is not None:
        pos_big = pos_big + torch.einsum("zkmab,zkn->zkmanb", anchor_pos, anchor_onehot)
        att_big = att_big + torch.einsum("zkmab,zkn->zkmanb", anchor_att, anchor_onehot)
    lead = j_pos.shape[:2]
    h = torch.cat(
        [
            torch.zeros(lead + (m, 2, 15), dtype=dtype, device=dev),
            pos_big.reshape(lead + (m, 2, 3 * m)),
            att_big.reshape(lead + (m, 2, 3 * m)),
            torch.zeros(lead + (m, 2, 3 * n), dtype=dtype, device=dev),
        ],
        dim=-1,
    )
    return h.reshape(lead + (2 * m, 15 + 6 * m + 3 * n))


def build(
    obs: torch.Tensor,  # (A, K, M, 2) normalized coords, window-aligned
    mask: torch.Tensor,  # (A, K, M) bool
    q_arr: torch.Tensor,  # (A, M, 4)
    p_arr: torch.Tensor,  # (A, M, 3)
    cov: torch.Tensor,  # (A, D, D)
    sigma_img: float,
    n_features: int,
    max_iter: int = 10,
    term: float = 1e-5,
    oc: bool = True,
    fixed_world=None,
):
    """Returns (UpdateRows with K*(2M-3) rows per agent, MsckfTrackInfo).

    ``fixed_world`` (A, K, 3): reuse these triangulated world points instead
    of re-triangulating (required for IEKF iterations > 0)."""
    a, k, m, _ = obs.shape
    dtype, dev = cov.dtype, cov.device
    d = cov.shape[-1]
    g_vec = constant(GRAVITY, dtype, dev)

    n_obs = torch.sum(mask, dim=-1)
    enough = n_obs >= 2
    if fixed_world is None:
        ivd, anchor = triangulation.triangulate_gn(obs, mask, q_arr, p_arr, max_iter, term)
        ar = torch.arange(a, device=dev)[:, None]
        g_p_f = triangulation.ivd_to_world(ivd, q_arr[ar, anchor.long()], p_arr[ar, anchor.long()])
    else:
        ivd = torch.zeros((a, k, 3), dtype=dtype, device=dev)
        anchor = torch.zeros((a, k), dtype=torch.int32, device=dev)
        g_p_f = fixed_world
    res, j_pos, j_att, hf, finite = _obs_jacobians(g_p_f, obs, mask, q_arr, p_arr, g_vec, oc)
    h_j = _assemble_h(j_pos, j_att, m, n_features)
    h0, res0, _, _ = linalg.nullspace_project(
        hf.reshape(a, k, 2 * m, 3), h_j, res.reshape(a, k, 2 * m)
    )
    # chi2(2m-3, 0.95) gate on the whitened projected system
    gamma = linalg.mahalanobis_gamma(cov[:, None], h0 / sigma_img, res0 / sigma_img)
    inlier = chi2_gate(gamma, 2 * n_obs - 3, 0.95, 2 * m)
    valid = enough & finite & torch.isfinite(gamma)
    keep = inlier & valid
    h0 = torch.where(keep[..., None, None], h0, 0.0)
    res0 = torch.where(keep[..., None], res0, 0.0)

    rows = k * (2 * m - 3)
    update = UpdateRows(
        jac=h0.reshape(a, rows, d),
        res=res0.reshape(a, rows),
        noise_std=torch.full((a, rows), sigma_img, dtype=dtype, device=dev),
    )
    info = MsckfTrackInfo(ivd=ivd, anchor=anchor, world=g_p_f, inlier=keep, valid=valid)
    return update, info
