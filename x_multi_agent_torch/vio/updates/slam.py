"""SLAM (persistent inverse-depth feature) update (port of
``x_multi_agent_tpu.vio.updates.slam``).

For each active SLAM feature with a fresh observation: residual of the last
observation vs the inverse-depth prediction from the anchor pose; Jacobians
wrt current pose, anchor pose and feature (anchor == current pose special
case); chi2(2 * track_length, 0.90) gate (``track_rows.slam_rows``: the
hand-written kernel on the card). Inactive or gated slots yield zero rows.
"""
from __future__ import annotations

import torch

from ...ops import lie
from . import track_rows
from .common import UpdateRows, projection_blocks
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
    a = q_arr.shape[0]
    n = f_arr.shape[1]
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

    return UpdateRows(*track_rows.slam_rows(
        res_j, j_pos, j_att, j_anchor_pos, j_anchor_att, hf, anchor_idx, cov, cur_pose_idx,
        sigma_img, track_length, active & finite, max_track_length,
    ), torch.full((a, 2 * n), sigma_img, dtype=dtype, device=dev))
