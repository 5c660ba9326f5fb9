"""SLAM (persistent inverse-depth feature) update (port of
``x_multi_agent_tpu.vio.updates.slam``).

For each active SLAM feature with a fresh observation: residual of the last
observation vs the inverse-depth prediction from the anchor pose; Jacobians
wrt current pose, anchor pose and feature (anchor == current pose special
case); chi2(2 * track_length, 0.90) gate. Inactive or gated slots yield zero
rows.
"""
from __future__ import annotations

import torch

from ...ops import lie, linalg
from ...utils.chi2 import chi2_gate
from .common import (UpdateRows, feature_col, pose_att_col, pose_pos_col,
                     projection_blocks, scatter_block)
from .msckf_slam import _inv_depth_jac


def build(
    f_arr: torch.Tensor,  # (A, N, 3) inverse-depth (alpha, beta, rho)
    anchor_idx: torch.Tensor,  # (A, N) window index of anchor pose
    q_arr: torch.Tensor,  # (A, M, 4) camera attitudes (world<-cam)
    p_arr: torch.Tensor,  # (A, M, 3) camera positions
    z_obs: torch.Tensor,  # (A, N, 2) current-frame normalized observation
    active: torch.Tensor,  # (A, N) bool: feature has an observation this frame
    track_length: torch.Tensor,  # (A, N) for the chi2 dof (2 * len)
    cov: torch.Tensor,  # (A, D, D) prior covariance (for the gate)
    cur_pose_idx: int,  # index of the current pose in the window
    sigma_img: float,
    max_track_length: int = 60,
) -> UpdateRows:
    a, m = q_arr.shape[:2]
    n = f_arr.shape[1]
    d = cov.shape[-1]
    dtype, dev = cov.dtype, cov.device

    r_cw_cur = lie.quat_to_rot(q_arr[:, cur_pose_idx]).transpose(-1, -2)[:, None]  # (A,1,3,3)
    p_cur = p_arr[:, cur_pose_idx][:, None]
    ar = torch.arange(a, device=dev)[:, None]
    a_idx = anchor_idx.long()
    r_wa = lie.quat_to_rot(q_arr[ar, a_idx])  # (A, N, 3, 3)
    p_a = p_arr[ar, a_idx]

    alpha, beta, rho = f_arr[..., 0], f_arr[..., 1], f_arr[..., 2]
    safe_rho = torch.where(torch.abs(rho) > 1e-12, rho, torch.ones_like(rho))
    bearing = torch.stack([alpha, beta, torch.ones_like(alpha)], dim=-1)
    g_p_f = (r_wa @ bearing[..., None])[..., 0] / safe_rho[..., None] + p_a
    pt_cam = (r_cw_cur @ (g_p_f - p_cur)[..., None])[..., 0]
    j_i, pred, finite = projection_blocks(pt_cam)
    res_j = z_obs - pred

    # general case Jacobians
    rho_b = safe_rho[..., None, None]
    j_att = j_i @ lie.skew(pt_cam)
    j_pos = -j_i @ r_cw_cur
    j_anchor_att = -1.0 / rho_b * j_i @ r_cw_cur @ r_wa @ lie.skew(bearing)
    j_anchor_pos = -j_pos
    hf = (1.0 / rho_b) * j_i @ r_cw_cur @ r_wa @ _inv_depth_jac(alpha, beta, safe_rho)

    h0 = torch.zeros((a, n, 2, d), dtype=dtype, device=dev)
    feat = torch.arange(n, device=dev)
    h_gen = scatter_block(h0, j_pos, pose_pos_col(cur_pose_idx, m))
    h_gen = scatter_block(h_gen, j_att, pose_att_col(cur_pose_idx, m))
    h_gen = scatter_block(h_gen, j_anchor_pos, pose_pos_col(a_idx, m))
    h_gen = scatter_block(h_gen, j_anchor_att, pose_att_col(a_idx, m))
    h_gen = scatter_block(h_gen, hf, feature_col(feat, m))
    # anchor == current pose: rows are [[1,0,0],[0,1,0]] on the feature block
    eye_blk = torch.eye(3, dtype=dtype, device=dev)[:2].expand(a, n, 2, 3)
    h_special = scatter_block(h0, eye_blk, feature_col(feat, m))
    h_all = torch.where((anchor_idx == cur_pose_idx)[..., None, None], h_special, h_gen)

    gamma = linalg.mahalanobis_gamma(cov[:, None], h_all / sigma_img, res_j / sigma_img)
    inlier = chi2_gate(gamma, 2 * track_length, 0.90, 2 * max_track_length)
    keep = active & inlier & finite
    h_out = torch.where(keep[..., None, None], h_all, 0.0).reshape(a, 2 * n, d)
    res_out = torch.where(keep[..., None], res_j, 0.0).reshape(a, 2 * n)
    noise = torch.full((a, 2 * n), sigma_img, dtype=dtype, device=dev)
    return UpdateRows(h_out, res_out, noise)
