"""Laser range-finder (LRF) updates (port of
``x_multi_agent_tpu.vio.updates.range``).

``build``: predicted range from the intersection of the LRF ray (through a
fixed image point) with the plane of a facet of three SLAM features;
Jacobians with respect to the current camera pose and the three features'
anchors and inverse depths. ``build_per_feature``: the range as the depth
of one SLAM feature in the current camera. One masked row per agent, each
behind a chi2(1, 0.90) gate.
"""
from __future__ import annotations

import torch

from ...ops import lie, linalg
from ...utils.chi2 import chi2_threshold
from ...utils.tree import take
from .common import UpdateRows, feature_col, pose_att_col, pose_pos_col, scatter_block
from .msckf_slam import _inv_depth_jac

_GATE1 = chi2_threshold(0.90, 1, 4)


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(x) > eps, x, torch.ones_like(x))


def _col(x: torch.Tensor) -> torch.Tensor:
    """(A,) -> (A, 1, 1) for scaling (A, 1, 3) blocks."""
    return x[:, None, None]


def _gate(h, res, cov, sigma_range: float, keep):
    gamma = linalg.mahalanobis_gamma(cov, h / sigma_range, res[:, None] / sigma_range)
    keep = keep & (gamma < _GATE1) & torch.isfinite(res)
    noise = torch.full((res.shape[0], 1), sigma_range, dtype=cov.dtype, device=cov.device)
    return UpdateRows(torch.where(_col(keep), h, 0.0), torch.where(keep, res, 0.0)[:, None], noise)


def build(
    range_meas: torch.Tensor,  # (A,) measured range [m]
    img_pt_n: torch.Tensor,  # (A, 2) normalized undistorted LRF image point
    tr_feat_ids: torch.Tensor,  # (A, 3) SLAM feature slots of the facet
    f_arr: torch.Tensor,  # (A, N, 3)
    anchor_idx: torch.Tensor,  # (A, N)
    q_arr: torch.Tensor,  # (A, M, 4)
    p_arr: torch.Tensor,  # (A, M, 3)
    cov: torch.Tensor,  # (A, D, D)
    cur_pose_idx: int,
    sigma_range: float,
    active: torch.Tensor,  # (A,) a valid facet was found this frame
) -> UpdateRows:
    a, m = q_arr.shape[:2]
    d = cov.shape[-1]
    dtype, dev = cov.dtype, cov.device

    f3 = take(f_arr, tr_feat_ids)  # (A, 3, 3)
    a3 = take(anchor_idx, tr_feat_ids)  # (A, 3)
    rho = _safe(f3[..., 2], 1e-12)
    bear = torch.cat([f3[..., :2], torch.ones_like(f3[..., :1])], dim=-1)
    r_wa = lie.quat_to_rot(take(q_arr, a3))  # (A, 3, 3, 3)
    g_p_f = (r_wa @ bear[..., None])[..., 0] / rho[..., None] + take(p_arr, a3)

    p_cur = p_arr[:, cur_pose_idx]
    r_wc = lie.quat_to_rot(q_arr[:, cur_pose_idx])
    r_cw = r_wc.transpose(-1, -2)
    g_n = torch.linalg.cross(g_p_f[:, 0] - g_p_f[:, 1], g_p_f[:, 2] - g_p_f[:, 1])
    pt_nh = torch.cat([img_pt_n, torch.ones_like(img_pt_n[:, :1])], dim=-1)
    num = torch.sum((g_p_f[:, 1] - p_cur) * g_n, dim=-1)
    b_safe = _safe(torch.sum(pt_nh * (r_cw @ g_n[..., None])[..., 0], dim=-1), 1e-12)
    res = range_meas.to(dtype) - num / b_safe

    h = torch.zeros((a, 1, d), dtype=dtype, device=dev)
    j_pc = _col(-1.0 / b_safe) * g_n[:, None, :]
    j_qc = _col(num / b_safe**2) * (g_n[:, None, :] @ r_wc @ lie.skew(pt_nh))
    h = scatter_block(h, j_pc, pose_pos_col(cur_pose_idx, m))
    h = scatter_block(h, j_qc, pose_att_col(cur_pose_idx, m))

    g_p_r = _col(num / b_safe)[:, 0] * (r_wc @ pt_nh[..., None])[..., 0] + p_cur
    g_p_bary = torch.mean(g_p_f, dim=1)
    # per-vertex Jacobians; edge ordering of the reference (range_update.cpp:146-205)
    for j, (o0, o1) in enumerate(((2, 1), (0, 2), (1, 0))):
        e = g_p_f[:, o0] - g_p_f[:, o1]
        j_f = _col(1.0 / b_safe) * (g_n / 3.0 + torch.linalg.cross(e, g_p_bary - g_p_r))[:, None, :]
        j_qcj = _col(-1.0 / rho[:, j]) * j_f @ r_wa[:, j] @ lie.skew(bear[:, j])
        mat = _inv_depth_jac(f3[:, j, 0], f3[:, j, 1], rho[:, j])
        j_fij = _col(1.0 / rho[:, j]) * j_f @ r_wa[:, j] @ mat
        h = scatter_block(h, j_f, pose_pos_col(a3[:, j], m))
        h = scatter_block(h, j_qcj, pose_att_col(a3[:, j], m))
        h = scatter_block(h, j_fij, feature_col(tr_feat_ids[:, j], m))
    return _gate(h, res, cov, sigma_range, active)


def build_per_feature(
    range_meas: torch.Tensor,  # (A,) measured range [m]
    feat_idx: torch.Tensor,  # (A,) SLAM feature slot the LRF is assumed to hit
    f_arr: torch.Tensor,  # (A, N, 3)
    anchor_idx: torch.Tensor,  # (A, N)
    q_arr: torch.Tensor,  # (A, M, 4)
    p_arr: torch.Tensor,  # (A, M, 3)
    cov: torch.Tensor,  # (A, D, D)
    cur_pose_idx: int,
    sigma_range: float,
    active: torch.Tensor,  # (A,)
) -> UpdateRows:
    """Residual: measured range minus the depth of SLAM feature
    ``feat_idx`` in the current camera frame (the reference's unused
    ``processRangedFeature``); anchor == current pose needs no special case,
    the pose terms cancel in the general algebra."""
    a, m = q_arr.shape[:2]
    d = cov.shape[-1]
    dtype, dev = cov.dtype, cov.device
    ar = torch.arange(a, device=dev)

    fi = feat_idx.long()
    f = f_arr[ar, fi]
    a_idx = anchor_idx[ar, fi]
    a_safe = torch.clamp(a_idx, min=0).long()
    rho = _safe(f[:, 2], 1e-12)
    bear = torch.stack([f[:, 0], f[:, 1], torch.ones_like(f[:, 0])], dim=-1)
    r_wa = lie.quat_to_rot(q_arr[ar, a_safe])
    g_p_f = (r_wa @ bear[..., None])[..., 0] / rho[:, None] + p_arr[ar, a_safe]

    r_cw = lie.quat_to_rot(q_arr[:, cur_pose_idx]).transpose(-1, -2)
    pt_cam = (r_cw @ (g_p_f - p_arr[:, cur_pose_idx])[..., None])[..., 0]
    res = range_meas.to(dtype) - pt_cam[:, 2]

    j_i = torch.eye(3, dtype=dtype, device=dev)[2:]  # d(range)/d(pt_cam) = [0, 0, 1]
    j_att = j_i @ lie.skew(pt_cam)
    j_pos = -j_i @ r_cw
    j_anchor_att = _col(-1.0 / rho) * j_i @ r_cw @ r_wa @ lie.skew(bear)
    j_f = _col(1.0 / rho) * j_i @ r_cw @ r_wa @ _inv_depth_jac(f[:, 0], f[:, 1], rho)

    h = torch.zeros((a, 1, d), dtype=dtype, device=dev)
    h = scatter_block(h, j_pos, pose_pos_col(cur_pose_idx, m))
    h = scatter_block(h, j_att, pose_att_col(cur_pose_idx, m))
    h = scatter_block(h, -j_pos, pose_pos_col(a_safe, m))
    h = scatter_block(h, j_anchor_att, pose_att_col(a_safe, m))
    h = scatter_block(h, j_f, feature_col(fi, m))
    return _gate(h, res, cov, sigma_range, active & (a_idx >= 0))
