"""Vision-state bookkeeping on the EKF state (port of
``x_multi_agent_tpu.vio.state_manager``).

Lost-SLAM-feature excision, anchor reparametrization (Li RSS'12 eq. 38),
sliding-window shift and pose augmentation, each as a (D, D) transform:
applied alone by :func:`remove_features`, :func:`reparametrize_features`,
:func:`slide_window` and :func:`augment_pose`, and composed into ONE
sandwich ``T @ cov @ T.T`` by :func:`manage`; plus MSCKF-SLAM (Li 2012) and
standard inverse-depth feature initialization. Batched over agents (A, ...).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ekf.state import CoreState, StateDims, VisionState, camera_orientation, camera_position
from ..ops import lie
from ..ops.linalg import inv3
from ..utils.const import constant
from ..utils.tree import take, where


def _full_index_map(dims: StateDims, device, pose_map=None, feat_map=None):
    """D-index gather map from per-pose / per-feature slot maps (entries =
    source slot, or -1 to zero the target slot); maps are (M,) / (N,) or
    (A, M) / (A, N). Returns (idx (..., D), zero_mask (..., D))."""
    m, n = dims.n_poses, dims.n_features
    if pose_map is None:
        pose_map = torch.arange(m, device=device)
    if feat_map is None:
        feat_map = torch.arange(n, device=device)
    lead = torch.broadcast_shapes(pose_map.shape[:-1], feat_map.shape[:-1])
    off = torch.arange(3, device=device)

    def expand(base, mp):
        mp = mp.long().expand(lead + mp.shape[-1:])
        src = base + 3 * torch.clamp(mp, min=0)[..., None] + off
        return src.reshape(lead + (-1,)), (mp < 0).repeat_interleave(3, dim=-1)

    pos_idx, pos_zero = expand(15, pose_map)
    att_idx, att_zero = expand(15 + 3 * m, pose_map)
    feat_idx, feat_zero = expand(15 + 6 * m, feat_map)
    core = torch.arange(15, device=device).expand(lead + (15,))
    idx = torch.cat([core, pos_idx, att_idx, feat_idx], dim=-1)
    zero = torch.cat([torch.zeros_like(core, dtype=torch.bool), pos_zero, att_zero, feat_zero], dim=-1)
    return idx, zero


def _perm_matrix(idx, zero, d, dtype):
    """(..., D, D) one-hot matrix P with P @ cov @ P.T == the index-map
    gather of cov (rows/cols flagged in ``zero`` zeroed)."""
    p = (idx[..., :, None] == torch.arange(d, device=idx.device)).to(dtype)
    return torch.where(zero[..., :, None], torch.zeros((), dtype=dtype, device=idx.device), p)


# ---------------------------------------------------------------------------
# lost feature removal
# ---------------------------------------------------------------------------


def _remove_features_t(dims: StateDims, vision: VisionState, lost, dtype):
    """Vision part of lost-feature excision + its (A, D, D) transform.
    Returns (vision, t, perm, n_keep)."""
    from .track_manager import stable_partition

    n = dims.n_features
    ar = torch.arange(n, device=lost.device)
    active = ar < vision.n_valid_features[:, None]
    keep = active & ~lost
    perm = stable_partition(keep)
    n_keep = torch.sum(keep, dim=1).to(torch.int32)
    keep_sorted = ar < n_keep[:, None]
    f_arr = torch.where(keep_sorted[..., None], take(vision.f_arr, perm), 0.0)
    anchor = torch.where(keep_sorted, take(vision.anchor_idx, perm), -1)
    feat_map = torch.where(keep_sorted, perm, -1)
    idx, zero = _full_index_map(dims, lost.device, feat_map=feat_map)
    t = _perm_matrix(idx, zero, dims.d, dtype)
    vision = dataclasses.replace(vision, f_arr=f_arr, anchor_idx=anchor, n_valid_features=n_keep)
    return vision, t, perm, n_keep


def _sandwich(t, cov):
    return t @ cov @ t.transpose(-1, -2)


def remove_features(dims: StateDims, vision: VisionState, cov, lost):
    """Excise lost SLAM features (A, N) and compact the survivors to the
    front. Returns (vision, cov, perm, n_keep); apply ``perm`` / ``n_keep``
    to the track slots too."""
    vision, t, perm, n_keep = _remove_features_t(dims, vision, lost, cov.dtype)
    return vision, _sandwich(t, cov), perm, n_keep


# ---------------------------------------------------------------------------
# reparametrization (Li RSS'12 eq. 38)
# ---------------------------------------------------------------------------


def _reparametrize_t(dims: StateDims, vision: VisionState, dtype):
    """Re-anchor features anchored at window slot 0 to slot M-1: vision part
    + the (A, D, D) Jacobian."""
    m, n = dims.n_poses, dims.n_features
    d = dims.d
    dev = vision.f_arr.device
    active = torch.arange(n, device=dev) < vision.n_valid_features[:, None]
    needs = active & (vision.anchor_idx == 0)

    r_old = lie.quat_to_rot(vision.q_arr[:, 0])[:, None]  # (A, 1, 3, 3)
    r_new = lie.quat_to_rot(vision.q_arr[:, m - 1])[:, None]
    p_old = vision.p_arr[:, 0][:, None]  # (A, 1, 3)
    p_new = vision.p_arr[:, m - 1][:, None]
    r_new_t = r_new.transpose(-1, -2)

    f = vision.f_arr  # (A, N, 3)
    alpha_o, beta_o, rho_o = f[..., 0], f[..., 1], f[..., 2]
    rho_safe = torch.where(torch.abs(rho_o) > 1e-12, rho_o, torch.ones_like(rho_o))
    bear_o = torch.stack([alpha_o, beta_o, torch.ones_like(alpha_o)], dim=-1)
    r_old_bear = (r_old @ bear_o[..., None])[..., 0]
    new_params = (r_new_t @ (-p_new + p_old + r_old_bear / rho_safe[..., None])[..., None])[..., 0]
    z = new_params[..., 2]
    z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    rho_n = 1.0 / z
    alpha_n = new_params[..., 0] * rho_n
    beta_n = new_params[..., 1] * rho_n
    f_new = torch.stack([alpha_n, beta_n, rho_n], dim=-1)

    inv_rho = (-1.0 / rho_safe)[..., None, None]
    j_a_att_old = inv_rho * r_new_t @ r_old @ lie.skew(bear_o)
    j_a_att_new = lie.skew(new_params)
    shape = j_a_att_new.shape
    j_a_pos_old = r_new_t.expand(shape)
    j_a_pos_new = -r_new_t.expand(shape)
    one, zero = torch.ones_like(alpha_o), torch.zeros_like(alpha_o)
    mat_o = torch.stack([
        torch.stack([one, zero, -alpha_o / rho_safe], -1),
        torch.stack([zero, one, -beta_o / rho_safe], -1),
        torch.stack([zero, zero, -1.0 / rho_safe], -1),
    ], dim=-2)
    j_feat_old = (1.0 / rho_safe)[..., None, None] * r_new_t @ r_old @ mat_o

    lead = shape[:-2]
    z_mid = torch.zeros(lead + (3, 3 * (m - 2)), dtype=dtype, device=dev)
    a_j = torch.cat([
        torch.zeros(lead + (3, 15), dtype=dtype, device=dev),
        j_a_pos_old, z_mid, j_a_pos_new,
        j_a_att_old, z_mid, j_a_att_new,
        torch.zeros(lead + (3, 3 * n), dtype=dtype, device=dev),
    ], dim=-1)  # (A, N, 3, D)
    # the own-feature block lands via a one-hot selector (feature j at column
    # 15 + 6M + 3j)
    cols = torch.arange(d, device=dev)
    tgt = 15 + 6 * m + 3 * torch.arange(n, device=dev)[:, None] + torch.arange(3, device=dev)
    sel = (cols == tgt[..., None]).to(dtype)  # (N, 3, D)
    a_j = a_j + j_feat_old @ sel

    mat_n = torch.stack([
        torch.stack([one, zero, -alpha_n], -1),
        torch.stack([zero, one, -beta_n], -1),
        torch.stack([zero, zero, -rho_n], -1),
    ], dim=-2)
    rows = rho_n[..., None, None] * mat_n @ a_j  # (A, N, 3, D)

    f_arr = torch.where(needs[..., None], f_new, vision.f_arr)
    anchor = torch.where(needs, m - 1, vision.anchor_idx).to(torch.int32)

    a = f.shape[0]
    jmat = torch.eye(d, dtype=dtype, device=dev).expand(a, d, d)
    feat_rows = jmat[:, 15 + 6 * m :].reshape(a, n, 3, d)
    feat_rows = torch.where(needs[..., None, None], rows, feat_rows)
    jmat = torch.cat([jmat[:, : 15 + 6 * m], feat_rows.reshape(a, 3 * n, d)], dim=1)
    return dataclasses.replace(vision, f_arr=f_arr, anchor_idx=anchor), jmat


def reparametrize_features(dims: StateDims, vision: VisionState, cov):
    """Re-anchor the features anchored at window slot 0 to the newest slot
    M-1 (runs right before the window slides). Returns (vision, cov)."""
    vision, jmat = _reparametrize_t(dims, vision, cov.dtype)
    return vision, _sandwich(jmat, cov)


# ---------------------------------------------------------------------------
# window slide
# ---------------------------------------------------------------------------


def _slide_t(dims: StateDims, vision: VisionState, dtype):
    """Window slide: vision part + its constant (D, D) shift-and-zero
    transform."""
    m = dims.n_poses
    dev = vision.p_arr.device
    pose_map = torch.cat([torch.arange(1, m, device=dev), torch.full((1,), -1, device=dev)])
    idx, zero = _full_index_map(dims, dev, pose_map=pose_map)
    t = _perm_matrix(idx, zero, dims.d, dtype)

    p_arr = torch.cat([vision.p_arr[:, 1:], torch.zeros_like(vision.p_arr[:, :1])], dim=1)
    q_id = lie.quat_identity(dtype, dev).expand_as(vision.q_arr[:, :1])
    q_arr = torch.cat([vision.q_arr[:, 1:], q_id], dim=1)
    active = torch.arange(dims.n_features, device=dev) < vision.n_valid_features[:, None]
    anchor = torch.where(active, vision.anchor_idx - 1, vision.anchor_idx).to(torch.int32)
    # right-aligned window: sliding an invalid leading slot out keeps the
    # valid count; sliding a valid one (full window) drops it by one
    n_valid = torch.where(
        vision.n_valid_poses == m, vision.n_valid_poses - 1, vision.n_valid_poses
    ).to(torch.int32)
    vision = dataclasses.replace(
        vision, p_arr=p_arr, q_arr=q_arr, anchor_idx=anchor, n_valid_poses=n_valid
    )
    return vision, t


def slide_window(dims: StateDims, vision: VisionState, cov):
    """Shift the window one slot toward the front, zeroing the newest slot.
    Returns (vision, cov)."""
    vision, t = _slide_t(dims, vision, cov.dtype)
    return vision, _sandwich(t, cov)


# ---------------------------------------------------------------------------
# pose augmentation
# ---------------------------------------------------------------------------


def _augment_t(dims: StateDims, core: CoreState, vision: VisionState, q_ic, p_ic, dtype):
    """Clone the current camera pose into slot M-1: vision part + the
    (A, D, D) augmentation Jacobian."""
    m = dims.n_poses
    d = dims.d
    pos = m - 1
    a = core.p.shape[0]
    dev = core.p.device
    p_arr = vision.p_arr.clone()
    q_arr = vision.q_arr.clone()
    p_arr[:, pos] = camera_position(core, p_ic)
    q_arr[:, pos] = camera_orientation(core, q_ic)

    row_p = 15 + 3 * pos
    row_q = 15 + 3 * m + 3 * pos
    jmat = torch.eye(d, dtype=dtype, device=dev).repeat(a, 1, 1)
    jmat[:, row_p : row_p + 3, :] = 0.0
    jmat[:, row_q : row_q + 3, :] = 0.0
    # d(cam pos err)/d(imu pos err) = I ; /d(imu att err) = -C(q) [p_ic]x
    jmat[:, row_p : row_p + 3, 0:3] = torch.eye(3, dtype=dtype, device=dev)
    jmat[:, row_p : row_p + 3, 6:9] = -lie.quat_to_rot(core.q) @ lie.skew(p_ic)
    # d(cam att err)/d(imu att err) = C(q_ic)^T
    jmat[:, row_q : row_q + 3, 6:9] = lie.quat_to_rot(q_ic).transpose(-1, -2)
    vision = dataclasses.replace(
        vision, p_arr=p_arr, q_arr=q_arr,
        n_valid_poses=torch.clamp(vision.n_valid_poses + 1, max=m).to(torch.int32),
    )
    return vision, jmat


def augment_pose(dims: StateDims, core: CoreState, vision: VisionState, cov, q_ic, p_ic):
    """Clone the current camera pose into window slot M-1 (vacated and
    zeroed by the slide); the sandwich fills its rows and columns from the
    core covariance. Returns (vision, cov)."""
    vision, jmat = _augment_t(dims, core, vision, q_ic, p_ic, cov.dtype)
    return vision, _sandwich(jmat, cov)


# ---------------------------------------------------------------------------
# manage = remove + reparam + slide + augment
# ---------------------------------------------------------------------------


def manage(dims: StateDims, core: CoreState, vision: VisionState, cov, lost, q_ic, p_ic):
    """Remove lost features, reparametrize, slide and augment, with the four
    covariance transforms composed into one sandwich. Returns
    (vision, cov, perm, n_keep)."""
    dtype = cov.dtype
    vision, t_rm, perm, n_keep = _remove_features_t(dims, vision, lost, dtype)
    vision, j_rep = _reparametrize_t(dims, vision, dtype)
    vision, t_sl = _slide_t(dims, vision, dtype)
    vision, j_aug = _augment_t(dims, core, vision, q_ic, p_ic, dtype)
    t = j_aug @ (t_sl @ (j_rep @ t_rm))
    return vision, _sandwich(t, cov), perm, n_keep


# ---------------------------------------------------------------------------
# feature initialization
# ---------------------------------------------------------------------------


def init_new_features(
    dims: StateDims,
    vision: VisionState,
    cov: torch.Tensor,  # (A, D, D)
    is_msckf: torch.Tensor,  # (A, K) MSCKF-SLAM vs standard inverse-depth init
    h1: torch.Tensor,  # (A, K, 3, D) MSCKF-SLAM column-space Jacobian
    h2: torch.Tensor,  # (A, K, 3, 3)
    r1: torch.Tensor,  # (A, K, 3)
    features: torch.Tensor,  # (A, K, 3) triangulated inverse depth
    z_obs: torch.Tensor,  # (A, K, 2) last observation (standard-init seed)
    accept: torch.Tensor,  # (A, K) bool
    correction: torch.Tensor,  # (A, D)
    sigma_img: float,
    rho_0: float,
    sigma_rho_0: float,
):
    """Batched insertion of all accepted new features in candidate order, as
    one sandwich T P T^T + blkdiag(W_i): T is the identity with the new
    slots' rows G_i = -H2^-1 H1 (MSCKF-SLAM, Li 2012) or 0 (standard
    inverse-depth prior). Equal to the sequential inserts because H1 has
    zero columns at every feature slot."""
    m, n = dims.n_poses, dims.n_features
    d = dims.d
    dtype, dev = cov.dtype, cov.device
    var_img = sigma_img * sigma_img
    a, k = accept.shape

    order = torch.cumsum(accept.to(torch.int64), dim=1) - 1
    slot = vision.n_valid_features[:, None].long() + order
    ok = accept & (slot < n)
    n_ins = torch.sum(ok, dim=1).to(torch.int32)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    h2_inv = inv3(torch.where(is_msckf[..., None, None], h2, eye3))
    g_ms = -torch.einsum("zkab,zkbd->zkad", h2_inv, h1)
    f_ms = (
        features
        + torch.einsum("zkad,zd->zka", g_ms, correction)
        + torch.einsum("zkab,zkb->zka", h2_inv, r1)
    )
    w_ms = var_img * torch.einsum("zkab,zkcb->zkac", h2_inv, h2_inv)
    f_std = torch.cat([z_obs, torch.full((a, k, 1), rho_0, dtype=dtype, device=dev)], dim=-1)
    w_std = torch.diag(constant((var_img, var_img, sigma_rho_0 * sigma_rho_0), dtype, dev))
    g_rows = torch.where(is_msckf[..., None, None], g_ms, 0.0)
    w_blk = torch.where(is_msckf[..., None, None], w_ms, w_std)
    f_new = torch.where(is_msckf[..., None], f_ms, f_std)

    # feature slot -> candidate index (-1 = untouched slot)
    cand_by_slot = torch.full((a, n + 1), -1, dtype=torch.int64, device=dev)
    src = torch.arange(k, device=dev).expand(a, k)
    cand_by_slot = cand_by_slot.scatter(1, torch.where(ok, slot, n), src)[:, :n]
    is_new = cand_by_slot >= 0
    safe_cand = torch.clamp(cand_by_slot, min=0)

    t = torch.eye(d, dtype=dtype, device=dev).expand(a, d, d)
    feat_rows = t[:, 15 + 6 * m :].reshape(a, n, 3, d)
    feat_rows = torch.where(is_new[..., None, None], take(g_rows, safe_cand), feat_rows)
    t = torch.cat([t[:, : 15 + 6 * m], feat_rows.reshape(a, 3 * n, d)], dim=1)
    cov1 = t @ cov @ t.transpose(-1, -2)
    w_slot = torch.where(is_new[..., None, None], take(w_blk, safe_cand), 0.0)  # (A, N, 3, 3)
    w_big = torch.zeros((a, n, 3, n, 3), dtype=dtype, device=dev)
    rng_n = torch.arange(n, device=dev)
    w_big[:, rng_n, :, rng_n, :] = w_slot.transpose(0, 1)
    cov1 = cov1.clone()
    cov1[:, 15 + 6 * m :, 15 + 6 * m :] += w_big.reshape(a, 3 * n, 3 * n)

    vision = dataclasses.replace(
        vision,
        f_arr=torch.where(is_new[..., None], take(f_new, safe_cand), vision.f_arr),
        anchor_idx=torch.where(is_new, m - 1, vision.anchor_idx).to(torch.int32),
        n_valid_features=(vision.n_valid_features + n_ins).to(torch.int32),
    )
    return vision, cov1


def _insert_rows(cov, slot_row, block_rows, diag):
    """Per-agent write of a feature's (3, D) cross block at rows slot_row
    (A,), its transpose at those columns, then its (3, 3) diagonal block."""
    a, d, _ = cov.shape
    ar = torch.arange(a, device=cov.device)[:, None]
    r = slot_row[:, None] + torch.arange(3, device=cov.device)  # (A, 3)
    cov = cov.clone()
    cov[ar, r, :] = block_rows
    cov.transpose(1, 2)[ar, r, :] = block_rows
    cov[ar[..., None], r[:, :, None], r[:, None, :]] = diag
    return cov


def init_msckf_slam_features(
    dims: StateDims, vision: VisionState, cov, h1, h2, r1, features, accept,
    correction, sigma_img: float,
):
    """Sequentially insert MSCKF-SLAM features (Li 2012), so later features
    pick up cross-covariance with earlier ones."""
    m, n = dims.n_poses, dims.n_features
    var_img = sigma_img * sigma_img
    for i in range(accept.shape[1]):
        can = accept[:, i] & (vision.n_valid_features < n)
        slot = torch.clamp(vision.n_valid_features, max=n - 1).long()
        h2_inv = torch.linalg.inv(h2[:, i])
        h2_inv_h1 = h2_inv @ h1[:, i]
        f_new = (features[:, i] - (h2_inv_h1 @ correction[..., None])[..., 0]
                 + (h2_inv @ r1[:, i, :, None])[..., 0])
        cross = -h2_inv_h1 @ cov
        diag = h2_inv_h1 @ cov @ h2_inv_h1.transpose(-1, -2) + var_img * (
            h2_inv @ h2_inv.transpose(-1, -2))
        cov_i = _insert_rows(cov, 15 + 6 * m + 3 * slot, cross, diag)
        vis_i = _place_feature(vision, slot, f_new, m)
        cov = torch.where(can[:, None, None], cov_i, cov)
        vision = where(can, vis_i, vision)
    return vision, cov


def init_standard_slam_features(
    dims: StateDims, vision: VisionState, cov, z_obs, accept, rho_0: float,
    sigma_img: float, sigma_rho_0: float,
):
    """Sequential inverse-depth prior init (z_obs seeds alpha, beta)."""
    m, n = dims.n_poses, dims.n_features
    a, d, _ = cov.shape
    dtype, dev = cov.dtype, cov.device
    diag = torch.diag(torch.tensor(
        [sigma_img * sigma_img, sigma_img * sigma_img, sigma_rho_0 * sigma_rho_0],
        dtype=dtype, device=dev)).expand(a, 3, 3)
    zero_rows = torch.zeros((a, 3, d), dtype=dtype, device=dev)
    for i in range(accept.shape[1]):
        can = accept[:, i] & (vision.n_valid_features < n)
        slot = torch.clamp(vision.n_valid_features, max=n - 1).long()
        f_new = torch.cat([z_obs[:, i], torch.full((a, 1), rho_0, dtype=dtype, device=dev)], -1)
        cov_i = _insert_rows(cov, 15 + 6 * m + 3 * slot, zero_rows, diag)
        vis_i = _place_feature(vision, slot, f_new, m)
        cov = torch.where(can[:, None, None], cov_i, cov)
        vision = where(can, vis_i, vision)
    return vision, cov


def _place_feature(vision: VisionState, slot, f_new, m: int) -> VisionState:
    ar = torch.arange(slot.shape[0], device=slot.device)
    f_arr = vision.f_arr.clone()
    anchor = vision.anchor_idx.clone()
    f_arr[ar, slot] = f_new
    anchor[ar, slot] = m - 1  # anchored at the current pose
    return dataclasses.replace(
        vision, f_arr=f_arr, anchor_idx=anchor,
        n_valid_features=(vision.n_valid_features + 1).to(torch.int32),
    )

