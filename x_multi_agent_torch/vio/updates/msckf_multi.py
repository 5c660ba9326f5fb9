"""Cross-agent (multi-UAV) MSCKF update with N-way covariance intersection
(port of ``x_multi_agent_tpu.vio.updates.msckf_multi``).

For an own MSCKF track matched to tracks received from peers:
  * the landmark is triangulated jointly over every participant's
    observations and camera window (peers first, own last, so the anchor
    stays the own last observation);
  * each participant contributes the column-space projection of its
    reprojection system onto its feature Jacobian: 3 rows in its own layout;
  * the stacked feature Jacobian (3(P+1), 3) is nullspace-projected jointly
    and the projected rows split per participant;
  * S = sum_i (1/w_i) H_i P_i H_i^T + var I (fixed CI weights, or the
    on-device weight optimization for a negative ``ci_msckf_w``), a
    chi2(2 m_total - 3, 0.95) gate, the own observing pose blocks
    congruence-scaled by sqrt(w_result), then the CI update.

Agents are the leading axis; the K tracks are a Python loop (each fusion
changes the covariance the next one sees), and the reference's per-track
``lax.cond`` is a per-agent select. P peer slots per track; missing peers
contribute zero rows.
"""
from __future__ import annotations

import torch

from ...ekf import ci as ci_mod
from ...ekf.state import StateDims, correct_core, correct_vision
from ...ops import linalg, triangulation
from ...utils import tree
from ...utils.chi2 import chi2_gate
from ...utils.const import constant
from .msckf import GRAVITY, _obs_jacobians
from .track_rows import _assemble_h


def _participant_rows(g_p_f, obs, mask, q_arr, p_arr, g_vec, n_features: int, oc: bool):
    """Column-space projections of B participants' reprojection systems.
    g_p_f (B, 3); obs (B, M, 2); mask (B, M); q_arr/p_arr (B, M, .). Returns
    (h (B, 3, D), hf (B, 3, 3), res (B, 3), finite (B,))."""
    m = obs.shape[-2]
    res, j_pos, j_att, hf, finite = _obs_jacobians(
        g_p_f[:, None], obs[:, None], mask[:, None], q_arr, p_arr, g_vec, oc
    )
    h = _assemble_h(j_pos, j_att, m, n_features)[:, 0]  # (B, 2M, D)
    hf_t, h_t, res_t = linalg.householder_qt(
        hf[:, 0].reshape(-1, 2 * m, 3), h, res[:, 0].reshape(-1, 2 * m)
    )
    return h_t[:, :3], hf_t[:, :3], res_t[:, :3], finite[:, 0]


def apply_joint_msckf_ci_pairs(
    dims: StateDims,
    core,
    vision,
    cov: torch.Tensor,  # (A, D, D)
    own_obs: torch.Tensor,  # (A, K, M, 2) own MSCKF tracks (window-aligned)
    own_mask: torch.Tensor,  # (A, K, M)
    own_inlier: torch.Tensor,  # (A, K) own-track gate
    peer_p_arr: torch.Tensor,  # (A, K, P, M, 3) per-track peer camera windows
    peer_q_arr: torch.Tensor,  # (A, K, P, M, 4)
    peer_cov: torch.Tensor,  # (A, K, P, 6M, 6M) peer pose-window covariance blocks
    peer_obs: torch.Tensor,  # (A, K, P, M, 2) matched peer track observations
    peer_mask: torch.Tensor,  # (A, K, P, M)
    matched: torch.Tensor,  # (A, K, P) association valid
    sigma_img: float,
    ci_msckf_w: float,
    oc: bool = True,
):
    """Sequentially CI-fuse explicitly matched joint-MSCKF tracks, each
    against the own window as corrected by the tracks before it. (The
    reference's own-window override argument, which no caller passes, is not
    ported.) Returns (core, vision, cov, n_applied (A,))."""
    a, k, m, _ = own_obs.shape
    p_max = peer_p_arr.shape[2]
    d = cov.shape[-1]
    dtype, dev = cov.dtype, cov.device
    g_vec = constant(GRAVITY, dtype, dev)
    var_img = sigma_img * sigma_img
    ar = torch.arange(a, device=dev)
    rows = 3 * p_max
    eye_stack = torch.eye(3 * (p_max + 1), dtype=dtype, device=dev).expand(a, -1, -1)
    eye_rows = torch.eye(rows, dtype=dtype, device=dev)
    pose = slice(15, 15 + 6 * m)
    n_app = torch.zeros((a,), dtype=torch.int32, device=dev)
    for kidx in range(k):
        q_own, p_own = vision.q_arr, vision.p_arr
        oobs, omask = own_obs[:, kidx], own_mask[:, kidx]
        tmatched = matched[:, kidx]  # (A, P)
        pobs = peer_obs[:, kidx]  # (A, P, M, 2)
        pmask = peer_mask[:, kidx] & tmatched[..., None]
        pq, pp, pcov = peer_q_arr[:, kidx], peer_p_arr[:, kidx], peer_cov[:, kidx]

        # joint triangulation: peers first, own last (anchor = own last obs)
        obs_joint = torch.cat([pobs.reshape(a, -1, 2), oobs], 1)
        mask_joint = torch.cat([pmask.reshape(a, -1), omask], 1)
        q_joint = torch.cat([pq.reshape(a, -1, 4), q_own], 1)
        p_joint = torch.cat([pp.reshape(a, -1, 3), p_own], 1)
        ivd, anchor = triangulation.triangulate_gn(
            obs_joint[:, None], mask_joint[:, None], q_joint, p_joint
        )
        anc = anchor[:, 0].long()
        g_p_f = triangulation.ivd_to_world(ivd[:, 0], q_joint[ar, anc], p_joint[ar, anc])

        h_own, hf_own, r_own, fin_own = _participant_rows(
            g_p_f, oobs, omask, q_own, p_own, g_vec, dims.n_features, oc
        )
        h_p, hf_p, r_p, _ = _participant_rows(
            g_p_f.repeat_interleave(p_max, 0), pobs.reshape(a * p_max, m, 2),
            pmask.reshape(a * p_max, m), pq.reshape(a * p_max, m, 4),
            pp.reshape(a * p_max, m, 3), g_vec, dims.n_features, oc,
        )
        h_p = h_p.reshape(a, p_max, 3, d)

        # joint nullspace projection over the stacked feature Jacobian
        hf_stack = torch.cat([hf_own[:, None], hf_p.reshape(a, p_max, 3, 3)], 1)
        r_stack = torch.cat([r_own[:, None], r_p.reshape(a, p_max, 3)], 1)
        _, qt, res_t = linalg.householder_qt(
            hf_stack.reshape(a, -1, 3), eye_stack, r_stack.reshape(a, -1)
        )
        proj = qt[:, 3:].transpose(-1, -2)  # (A, 3(P+1), rows)
        res_proj = res_t[:, 3:]
        h_own_proj = proj[:, :3].transpose(-1, -2) @ h_own  # (A, rows, D)
        h_p_proj = torch.stack(
            [proj[:, 3 * (i + 1) : 3 * (i + 2)].transpose(-1, -2) @ h_p[:, i]
             for i in range(p_max)], 1
        )  # (A, P, rows, D)
        hp_pose = h_p_proj[..., pose]  # (A, P, rows, 6M)

        # N-way CI weights: fixed, or optimized on the device (w < 0)
        n_peers = torch.sum(tmatched, dim=1).to(dtype)
        if ci_msckf_w < 0:
            m_own = h_own_proj @ torch.linalg.inv_ex(cov).inverse @ h_own_proj.transpose(-1, -2)
            m_p = hp_pose @ torch.linalg.inv_ex(pcov).inverse @ hp_pose.transpose(-1, -2)
            w_all = ci_mod.optimize_weights_nway(m_own, m_p, tmatched, -ci_msckf_w)
            w0 = w_all[:, 0]
            w_peers = torch.clamp(w_all[:, 1:], min=1e-4)
        else:
            w0 = 1.0 - n_peers * ci_msckf_w
            w_peers = torch.full((a, p_max), ci_msckf_w, dtype=dtype, device=dev)
        s = (1.0 / w0)[:, None, None] * (h_own_proj @ cov @ h_own_proj.transpose(-1, -2))
        for i in range(p_max):
            s_i = hp_pose[:, i] @ pcov[:, i] @ hp_pose[:, i].transpose(-1, -2)
            s = s + torch.where(tmatched[:, i], 1.0 / w_peers[:, i], 0.0)[:, None, None] * s_i
        s = s + var_img * eye_rows

        gamma = torch.sum(res_proj * torch.linalg.solve_ex(s, res_proj[..., None]).result[..., 0], -1)
        dof = 2 * torch.sum(mask_joint, dim=1) - 3
        ok = (
            own_inlier[:, kidx]
            & (n_peers > 0)
            & chi2_gate(gamma, dof, 0.95, 2 * (p_max + 1) * m)
            & fin_own
            & torch.isfinite(gamma)
        )

        # inflate the observing poses' position/attitude blocks by congruence
        # (sqrt(w_result) on the involved rows and columns keeps ci_P PSD)
        sq = torch.sqrt(1.0 / w0)
        pose_scaled = torch.cat([omask, omask], 1).repeat_interleave(3, dim=1)  # (A, 6M)
        scale = torch.ones((a, d), dtype=dtype, device=dev)
        scale[:, pose] = torch.where(pose_scaled, sq[:, None], 1.0)
        ci_p = cov * scale[:, :, None] * scale[:, None, :]
        corr, cov1 = ci_mod.apply_ci(cov, ci_p, h_own_proj, res_proj, s)
        core = tree.where(ok, correct_core(core, corr), core)
        vision = tree.where(ok, correct_vision(vision, corr, dims), vision)
        cov = torch.where(ok[:, None, None], cov1, cov)
        n_app = n_app + ok.to(torch.int32)
    return core, vision, cov, n_app


def apply_joint_msckf_ci(
    dims: StateDims,
    core,
    vision,
    cov: torch.Tensor,  # (A, D, D)
    own_obs: torch.Tensor,  # (A, K, M, 2) own MSCKF tracks (window-aligned)
    own_mask: torch.Tensor,  # (A, K, M)
    own_inlier: torch.Tensor,  # (A, K) own-track MSCKF gate passed
    own_desc: torch.Tensor,  # (A, K, 32)
    own_desc_valid: torch.Tensor,  # (A, K)
    peer_p_arr: torch.Tensor,  # (A, P, M, 3)
    peer_q_arr: torch.Tensor,  # (A, P, M, 4)
    peer_cov: torch.Tensor,  # (A, P, 6M, 6M) peer pose-window covariance blocks
    peer_trk_obs: torch.Tensor,  # (A, P, Kt, M, 2)
    peer_trk_mask: torch.Tensor,  # (A, P, Kt, M)
    peer_trk_desc: torch.Tensor,  # (A, P, Kt, 32)
    peer_trk_desc_valid: torch.Tensor,  # (A, P, Kt)
    peer_valid: torch.Tensor,  # (A, P)
    sigma_img: float,
    ci_msckf_w: float,
    oc: bool = True,
    desc_abs_thr: float = 60.0,
):
    """Descriptor-match each own track to each peer's collaborative set
    (nearest Hamming distance, first index among ties, below
    ``desc_abs_thr``), then CI-fuse. Returns (core, vision, cov, n_applied)."""
    from ...place_recognition.descriptors import hamming_matrix

    a, k = own_obs.shape[:2]
    p_max = peer_p_arr.shape[1]
    big = torch.iinfo(torch.int32).max
    dmat = hamming_matrix(own_desc[:, None], peer_trk_desc)  # (A, P, K, Kt)
    dmat = torch.where(peer_trk_desc_valid[:, :, None, :], dmat, big)
    best = torch.argmin(dmat, dim=-1)  # (A, P, K)
    d_best = torch.gather(dmat, -1, best[..., None])[..., 0]
    peer_ok = (d_best < desc_abs_thr) & own_desc_valid[:, None] & peer_valid[..., None]

    bidx = best.transpose(1, 2)  # (A, K, P)
    ar = torch.arange(a, device=cov.device)[:, None, None]
    pr = torch.arange(p_max, device=cov.device)[None, None, :]
    pobs = peer_trk_obs[ar, pr, bidx]  # (A, K, P, M, 2)
    pmask = peer_trk_mask[ar, pr, bidx]  # (A, K, P, M)

    def brd(x):
        return x[:, None].expand((a, k) + x.shape[1:])

    return apply_joint_msckf_ci_pairs(
        dims, core, vision, cov, own_obs, own_mask, own_inlier,
        brd(peer_p_arr), brd(peer_q_arr), brd(peer_cov), pobs, pmask, peer_ok.transpose(1, 2),
        sigma_img, ci_msckf_w, oc=oc,
    )
