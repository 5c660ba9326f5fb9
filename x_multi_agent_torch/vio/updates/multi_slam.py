"""Cross-agent SLAM-SLAM update with covariance intersection (port of
``x_multi_agent_tpu.vio.updates.multi_slam``).

For each matched pair of SLAM landmarks (own feature j, peer feature j'):
residual = peer world landmark - own world landmark; own Jacobian with
respect to (anchor position, anchor attitude, feature inverse depth);
chi2(3, 0.90) gate; CI with the peer's projected landmark covariance; the
own anchor and feature blocks congruence-scaled by sqrt(w_result).

Agents are the leading axis. The reference's per-agent ``lax.cond`` on
"anything to apply" becomes the computed update selected per agent.
"""
from __future__ import annotations

import torch

from ...ekf import ci as ci_mod
from ...ekf.state import StateDims, correct_core, correct_vision
from ...ops import lie, linalg
from ...utils import timing, tree
from ...utils.chi2 import chi2_threshold
from ...utils.tree import take
from .msckf_slam import _inv_depth_jac

# chi2(3, 0.90) quantile, from the same table the reference gathers from
_GATE3 = chi2_threshold(0.90, 3, 4)


def _safe_rho(rho: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(rho) > 1e-12, rho, torch.ones_like(rho))


def _bearing(f: torch.Tensor) -> torch.Tensor:
    return torch.stack([f[..., 0], f[..., 1], torch.ones_like(f[..., 0])], dim=-1)


def landmark_world(f: torch.Tensor, q_a: torch.Tensor, p_a: torch.Tensor) -> torch.Tensor:
    """World position (..., 3) of inverse-depth features ``f`` (..., 3)
    anchored at camera poses (q_a (..., 4), p_a (..., 3))."""
    rot = lie.quat_to_rot(q_a)
    return (rot @ _bearing(f)[..., None])[..., 0] / _safe_rho(f[..., 2])[..., None] + p_a


def _landmark_jac_blocks(f: torch.Tensor, q_a: torch.Tensor):
    """(J_anchor_pos, J_anchor_att, Hf), each (..., 3, 3): d(G_p_f) with
    respect to (anchor position, anchor attitude, inverse depth)."""
    rho_s = _safe_rho(f[..., 2])
    r_wa = lie.quat_to_rot(q_a)
    inv = (1.0 / rho_s)[..., None, None]
    j_pos = torch.eye(3, dtype=f.dtype, device=f.device).expand(r_wa.shape)
    j_att = -inv * r_wa @ lie.skew(_bearing(f))
    hf = inv * r_wa @ _inv_depth_jac(f[..., 0], f[..., 1], rho_s)
    return j_pos, j_att, hf


def _block_cols(m: int, anchor: torch.Tensor, feat_id: torch.Tensor) -> torch.Tensor:
    """(..., 9) error-state columns of the anchor position, anchor attitude
    and feature blocks."""
    off = torch.arange(3, device=anchor.device)
    starts = torch.stack([15 + 3 * anchor, 15 + 3 * m + 3 * anchor, 15 + 6 * m + 3 * feat_id], -1)
    return (starts.long()[..., None] + off).flatten(-2)


def _scatter_rows(d: int, m: int, anchor, feat_id, j_pos, j_att, hf) -> torch.Tensor:
    """(..., 3, D) rows holding the three (3, 3) blocks at their columns (the
    blocks never overlap)."""
    blocks = torch.cat([j_pos, j_att, hf], dim=-1)  # (..., 3, 9)
    idx = _block_cols(m, anchor, feat_id)[..., None, :].expand(blocks.shape)
    h = torch.zeros(blocks.shape[:-1] + (d,), dtype=blocks.dtype, device=blocks.device)
    return h.scatter(-1, idx, blocks)


def _trace(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def apply_matches_pairs(
    dims: StateDims,
    core,
    vision,
    cov: torch.Tensor,  # (A, D, D)
    other_p_arr: torch.Tensor,  # (A, K, M, 3) per-match peer windows
    other_q_arr: torch.Tensor,  # (A, K, M, 4)
    other_f_arr: torch.Tensor,  # (A, K, N, 3)
    other_anchor: torch.Tensor,  # (A, K, N)
    other_lm_cov: torch.Tensor,  # (A, K, N, N, 3, 3) joint peer landmark covariances
    own_fid: torch.Tensor,  # (A, K) matched own feature slots
    other_fid: torch.Tensor,  # (A, K) matched peer feature slots
    match_valid: torch.Tensor,  # (A, K)
    sigma_landmark: float,
    ci_slam_w: float,
):
    """Apply K (masked) SLAM-SLAM CI updates one after another, each match
    against its own peer snapshot; each fusion changes ``cov`` for the next.
    A negative ``ci_slam_w`` fuses a match only when the peer's landmark
    covariance is the more confident (trace) one, with weight |w|.

    Returns (core, vision, cov, n_applied (A,), applied (A, K))."""
    m, d = dims.n_poses, dims.d
    dtype, dev = cov.dtype, cov.device
    a, k = own_fid.shape
    var_lm = sigma_landmark * sigma_landmark
    downhill_only = ci_slam_w < 0
    w_eff = abs(ci_slam_w)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    ar = torch.arange(a, device=dev)
    n_app = torch.zeros((a,), dtype=torch.int32, device=dev)
    applied = []
    n = vision.f_arr.shape[1]
    for i in range(k):
        # a masked match may carry the slot count N as its id: the reference's
        # gathers clamp it (a negative id wraps in both), CUDA's assert
        fid = torch.clamp(own_fid[:, i].long(), max=n - 1)
        ofid = torch.clamp(other_fid[:, i].long(), max=n - 1)
        lam = other_lm_cov[ar, i, ofid, ofid]  # (A, 3, 3)
        f = vision.f_arr[ar, fid]
        a_idx = torch.clamp(vision.anchor_idx[ar, fid], min=0).long()
        q_a = vision.q_arr[ar, a_idx]
        oa = torch.clamp(other_anchor[ar, i, ofid], min=0).long()
        res = (landmark_world(other_f_arr[ar, i, ofid], other_q_arr[ar, i, oa],
                              other_p_arr[ar, i, oa])
               - landmark_world(f, q_a, vision.p_arr[ar, a_idx]))
        h = _scatter_rows(d, m, a_idx, fid, *_landmark_jac_blocks(f, q_a))  # (A, 3, D)

        p_own = h @ cov @ h.transpose(-1, -2)
        s_gate = p_own + lam + var_lm * eye3
        gamma = torch.sum(res * linalg.solve3(s_gate, res), dim=-1)
        ok = match_valid[:, i] & (gamma < _GATE3) & torch.isfinite(res).all(-1)
        if downhill_only:
            ok = ok & (_trace(lam) < _trace(p_own))

        s, w_result = ci_mod.fuse_pairwise_proj(cov, h, lam, w_eff)
        s = s + var_lm * eye3
        # congruence scaling D P D of the involved rows and columns keeps
        # ci_P PSD with H ci_P H^T equal to the own term of S
        touched = torch.zeros((a, d), dtype=torch.bool, device=dev).scatter_(
            1, _block_cols(m, a_idx, fid), True)
        scale = torch.where(touched, torch.sqrt(w_result)[:, None], 1.0)
        ci_p = cov * scale[:, :, None] * scale[:, None, :]
        corr, cov1 = ci_mod.apply_ci(cov, ci_p, h, res, s)
        core = tree.where(ok, correct_core(core, corr), core)
        vision = tree.where(ok, correct_vision(vision, corr, dims), vision)
        cov = torch.where(ok[:, None, None], cov1, cov)
        n_app = n_app + ok.to(torch.int32)
        applied.append(ok)
    return core, vision, cov, n_app, torch.stack(applied, dim=1)


def apply_matches(
    dims: StateDims,
    core,
    vision,
    cov: torch.Tensor,  # (A, D, D)
    other_p_arr: torch.Tensor,  # (A, M, 3) one peer snapshot per agent
    other_q_arr: torch.Tensor,  # (A, M, 4)
    other_f_arr: torch.Tensor,  # (A, N, 3)
    other_anchor: torch.Tensor,  # (A, N)
    other_lm_cov: torch.Tensor,  # (A, N, N, 3, 3)
    own_fid: torch.Tensor,  # (A, K)
    other_fid: torch.Tensor,  # (A, K)
    match_valid: torch.Tensor,  # (A, K)
    sigma_landmark: float,
    ci_slam_w: float,
):
    """Apply one round's K SLAM-SLAM matches against one peer snapshot as a
    single joint 3K-row CI update, carrying the cross-match covariance on
    both sides (own: H P H^T; peer: the joint landmark covariance blocks).
    A negative ``ci_slam_w`` keeps a match only when the peer's landmark is
    the more confident one, with weight |w|.

    Returns (core, vision, cov, n_applied (A,), kept (A, K))."""
    m, d = dims.n_poses, dims.d
    dtype, dev = cov.dtype, cov.device
    a, k = own_fid.shape
    var_lm = sigma_landmark * sigma_landmark

    f = take(vision.f_arr, own_fid)  # (A, K, 3)
    a_idx = torch.clamp(take(vision.anchor_idx, own_fid), min=0)
    q_a = take(vision.q_arr, a_idx)
    oa = torch.clamp(take(other_anchor, other_fid), min=0)
    res_k = (landmark_world(take(other_f_arr, other_fid), take(other_q_arr, oa),
                            take(other_p_arr, oa))
             - landmark_world(f, q_a, take(vision.p_arr, a_idx)))
    h_k = _scatter_rows(d, m, a_idx, own_fid, *_landmark_jac_blocks(f, q_a))  # (A, K, 3, D)
    h = h_k.reshape(a, 3 * k, d)
    res = res_k.reshape(a, 3 * k)

    s_own = h @ cov @ h.transpose(-1, -2)  # (A, 3K, 3K) with cross-match terms
    ar = torch.arange(a, device=dev)[:, None, None]
    ofid = other_fid.long()
    lam = other_lm_cov[ar, ofid[:, :, None], ofid[:, None, :]]  # (A, K, K, 3, 3)
    lam = lam.permute(0, 1, 3, 2, 4).reshape(a, 3 * k, 3 * k)
    w = abs(ci_slam_w)
    if ci_slam_w < 0:
        own_tr = torch.diagonal(s_own, dim1=-2, dim2=-1).reshape(a, k, 3).sum(-1)
        peer_tr = torch.diagonal(lam, dim1=-2, dim2=-1).reshape(a, k, 3).sum(-1)
        match_valid = match_valid & (peer_tr < own_tr)
    eye = torch.eye(3 * k, dtype=dtype, device=dev)
    s_full = s_own / (1.0 - w) + lam / w + var_lm * eye

    # per-match chi2(3, 0.90) gate on the match's own 3x3 innovation block
    s3 = torch.diagonal(s_full.reshape(a, k, 3, k, 3), dim1=1, dim2=3).permute(0, 3, 1, 2)
    r3 = res.reshape(a, k, 3)
    gamma = torch.sum(r3 * linalg.solve3(s3, r3), dim=-1)
    keep = match_valid & (gamma < _GATE3) & torch.isfinite(r3).all(-1)
    keep3 = keep.repeat_interleave(3, dim=1)
    h = torch.where(keep3[..., None], h, 0.0)
    res = torch.where(keep3, res, 0.0)
    # dropped rows: an identity diagonal keeps S invertible, zero rows of H
    # and res make them no-ops
    s_full = (torch.where(keep3[:, :, None] & keep3[:, None, :], s_full, 0.0)
              + torch.diag_embed(torch.where(keep3, 0.0, 1.0).to(dtype)))

    # congruence-scale every own block a kept match touches (see
    # apply_matches_pairs)
    w_t = torch.full((), w, dtype=dtype, device=dev)
    sq = torch.sqrt(1.0 / (1.0 - w_t))
    hits = torch.zeros((a, d), dtype=torch.int32, device=dev).scatter_add(
        1, _block_cols(m, a_idx, own_fid).reshape(a, 9 * k),
        keep.to(torch.int32).repeat_interleave(9, dim=1),
    )
    scale = torch.where(hits > 0, sq, 1.0)
    ci_p = cov * scale[:, :, None] * scale[:, None, :]
    corr, cov1, solved = ci_mod.apply_ci_spd(cov, ci_p, h, res, s_full)
    # no update where S does not factorize (ROADMAP C21): no match is applied
    timing.tally("ci_dropped", torch.where(solved, 0, keep.sum(1)))
    keep = keep & solved[:, None]
    n_app = keep.sum(1).to(torch.int32)
    do = n_app > 0
    core = tree.where(do, correct_core(core, corr), core)
    vision = tree.where(do, correct_vision(vision, corr, dims), vision)
    cov = torch.where(do[:, None, None], cov1, cov)
    return core, vision, cov, n_app, keep
