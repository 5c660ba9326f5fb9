"""The per-frame visual update (port of ``x_multi_agent_tpu.vio.pipeline``).

One fixed-shape program per camera frame, batched over agents:

  track classification -> state management (remove/reparametrize/slide/
  augment) -> [IEKF x iekf_iter] stacked MSCKF (+ merged short-MSCKF) +
  MSCKF-SLAM + SLAM rows -> whitened compression -> Kalman update ->
  feature initialization

Everything is masked/fixed-budget; gated-out rows are zeros.

Ported here: the ``merge_short_into_stack=True`` path with the range and
sun rows, the debug payload and the collaboration store's branches
(``merge_short_into_stack=False`` raises).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..device import resolve
from ..ekf.state import (
    CoreState,
    StateDims,
    VisionState,
    camera_orientation,
    correct_core,
    correct_vision,
)
from ..ops import linalg
from ..ops.triangulation import ivd_to_world, triangulate_gn
from ..utils import timing
from ..utils.const import constant
from . import state_manager as sm
from . import track_manager as tm
from .range_facet import feature_triangle_at_point
from .updates import msckf, msckf_slam, range as range_upd, slam, solar


class VioConfig(NamedTuple):
    """Static VIO configuration (reference defaults)."""

    dims: StateDims = StateDims()
    tracks: tm.TrackDims = tm.TrackDims()
    q_ic: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    p_ic: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sigma_img: float = 0.005  # normalized-coordinate image noise std
    sigma_range: float = 0.05
    rho_0: float = 0.5
    sigma_rho_0: float = 0.25
    min_track_length: int = 15
    iekf_iter: int = 1
    tri_max_iter: int = 5  # GN-triangulation iteration cap
    msckf_baseline_x_n: float = 0.02
    msckf_baseline_y_n: float = 0.02
    obs_constrained: bool = True  # Hesch OC projection in MSCKF rows
    enable_range: bool = True
    enable_sun: bool = True
    merge_short_into_stack: bool = True


class FrameMeasurement(NamedTuple):
    """Per-frame inputs to the visual update, (A, ...) per field."""

    matches: tm.Matches
    range_value: torch.Tensor  # (A,)
    range_img_pt: torch.Tensor  # (A, 2)
    range_active: torch.Tensor  # (A,) bool
    sun_angles: torch.Tensor  # (A, 2)
    sun_active: torch.Tensor  # (A,) bool

    @staticmethod
    def from_matches(cfg: VioConfig, matches: tm.Matches) -> "FrameMeasurement":
        a = matches.cur_pt.shape[0]
        dtype, dev = matches.cur_pt.dtype, matches.cur_pt.device
        z = torch.zeros((a,), dtype=dtype, device=dev)
        f = torch.zeros((a,), dtype=torch.bool, device=dev)
        return FrameMeasurement(
            matches=matches, range_value=z, range_img_pt=torch.zeros((a, 2), dtype=dtype, device=dev),
            range_active=f, sun_angles=torch.zeros((a, 2), dtype=dtype, device=dev), sun_active=f,
        )


class FrameDebug(NamedTuple):
    """Per-frame observability payload (the reference's GUI accessors),
    (A, ...) per field; points in normalized undistorted coordinates."""

    msckf_cur: torch.Tensor  # (A, Km, 2) last obs of each MSCKF track
    msckf_inlier: torch.Tensor  # (A, Km) passed the chi2 gate
    msckf_valid: torch.Tensor  # (A, Km)
    short_cur: torch.Tensor  # (A, Ks, 2)
    short_valid: torch.Tensor  # (A, Ks)
    slam_cur: torch.Tensor  # (A, N, 2) current obs of SLAM features
    slam_valid: torch.Tensor  # (A, N)
    new_cur: torch.Tensor  # (A, Kn, 2)
    new_valid: torch.Tensor  # (A, Kn)
    new_is_msckf: torch.Tensor  # (A, Kn)
    opp_cur: torch.Tensor  # (A, Ko, 2) opportunistic pool current obs
    opp_valid: torch.Tensor  # (A, Ko)
    slam_cartesian: torch.Tensor  # (A, N, 3) world-frame SLAM landmarks
    slam_cart_valid: torch.Tensor  # (A, N)
    facet_ids: torch.Tensor  # (A, 3) SLAM indices of the LRF facet
    facet_found: torch.Tensor  # (A,)

    @staticmethod
    def zero(cfg: VioConfig, a: int, dtype=torch.float32, device=None) -> "FrameDebug":
        t, n = cfg.tracks, cfg.dims.n_features
        device = resolve(device)

        def z(*shape, dt=dtype):
            return torch.zeros((a,) + shape, dtype=dt, device=device)

        b = torch.bool
        return FrameDebug(
            msckf_cur=z(t.n_msckf, 2), msckf_inlier=z(t.n_msckf, dt=b),
            msckf_valid=z(t.n_msckf, dt=b), short_cur=z(t.n_short, 2),
            short_valid=z(t.n_short, dt=b), slam_cur=z(n, 2), slam_valid=z(n, dt=b),
            new_cur=z(t.n_new_slam, 2), new_valid=z(t.n_new_slam, dt=b),
            new_is_msckf=z(t.n_new_slam, dt=b), opp_cur=z(t.n_opp, 2),
            opp_valid=z(t.n_opp, dt=b), slam_cartesian=z(n, 3), slam_cart_valid=z(n, dt=b),
            facet_ids=torch.full((a, 3), -1, dtype=torch.int32, device=device),
            facet_found=z(dt=b),
        )


def _last_obs(obs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Last masked observation of each (A, K, M, 2) track window."""
    m = obs.shape[2]
    pos = torch.arange(m, device=obs.device)
    last = torch.amax(torch.where(mask, pos, -1), dim=2).clamp(min=0)
    return torch.gather(obs, 2, last[:, :, None, None].expand(-1, -1, 1, 2))[:, :, 0]


def _apply_rows(cov, jac, res, std, correction_total, cov_update=True):
    """Whiten -> (Gram-compress if rows > 2D) -> Kalman update."""
    d = cov.shape[-1]
    hw, rw = linalg.whiten(jac, res, std)
    if jac.shape[-2] > 2 * d:
        hw, rw = linalg.qr_compress(jac, res, std)
    corr, cov1 = linalg.kalman_update(cov, hw, rw, correction_total)
    return corr, (cov1 if cov_update else cov)


def visual_update(
    cfg: VioConfig,
    core: CoreState,
    vision: VisionState,
    cov: torch.Tensor,
    slots: tm.TrackSlots,
    meas: FrameMeasurement,
    store=None,
    collab_cfg=None,
    return_debug: bool = False,
):
    """One full visual update at the measurement state, per agent.

    With ``store`` (a :class:`parallel.match_store.MatchStore`) and
    ``collab_cfg`` (a ``CollabConfig``), stored cross-agent matches are
    upgraded and consumed inside the update: SLAM-SLAM upgrades and the
    matched dead tracks' joint short CI before state management, the
    matched MSCKF tracks' joint CI after the stacked update (those tracks
    leave the solo stack).

    Returns (core, vision, cov, slots), with a store (core, vision, cov,
    slots, store, n_collab (A,)), and a :class:`FrameDebug` after them with
    ``return_debug``."""
    dims = cfg.dims
    m, n = dims.n_poses, dims.n_features
    d = dims.d
    dtype, dev = cov.dtype, cov.device
    q_ic = constant(tuple(cfg.q_ic), dtype, dev)
    p_ic = constant(tuple(cfg.p_ic), dtype, dev)

    # ---------------- 1. track classification (pre-slide window) ----------
    timing.stamp("rows", cov)
    q_cur = camera_orientation(core, q_ic)
    slots, frame, slam_z = tm.manage_tracks(
        cfg.tracks, slots, meas.matches, vision.q_arr, q_cur, cfg.min_track_length,
        cfg.msckf_baseline_x_n, cfg.msckf_baseline_y_n,
        prev_pose_valid=vision.n_valid_poses >= 1,
    )

    # ---------------- 1b. persistent cross-agent match consumption --------
    if store is not None:
        store, work, frame, joint, n_collab, core, vision, cov = _consume_stored(
            cfg, collab_cfg, core, vision, cov, slots, frame, store
        )

    # ---------------- 1c. unmerged short-MSCKF update (pre-slide poses) ---
    if not cfg.merge_short_into_stack:
        short_rows, _ = msckf.build(
            frame.short_obs, frame.short_mask, vision.q_arr, vision.p_arr, cov, cfg.sigma_img, n,
            max_iter=cfg.tri_max_iter, oc=cfg.obs_constrained,
        )
        corr_short, cov_short = _apply_rows(cov, *short_rows, torch.zeros_like(cov[:, 0]))
        # agents with no dead track skip it (lax.cond in the reference)
        have_short = frame.short_valid.any(-1)
        corr_short = torch.where(have_short[:, None], corr_short, 0.0)
        cov = torch.where(have_short[:, None, None], cov_short, cov)
        core = correct_core(core, corr_short)
        vision = correct_vision(vision, corr_short, dims)

    # ---------------- 2. state management ---------------------------------
    vision, cov, perm, n_keep = sm.manage(dims, core, vision, cov, frame.lost_slam, q_ic, p_ic)
    slots = tm.apply_slam_compaction(slots, perm, n_keep)
    keep_sorted = torch.arange(n, device=dev) < n_keep[:, None]
    ar = torch.arange(perm.shape[0], device=dev)[:, None]
    slam_z = torch.where(keep_sorted[..., None], slam_z[ar, perm.long()], 0.0)
    slam_has_obs = torch.where(keep_sorted, frame.slam_has_obs[ar, perm.long()], False)
    slam_len = torch.where(keep_sorted, slots.slam_length, 0)
    cur_pose_idx = m - 1  # the window is right-aligned

    if cfg.merge_short_into_stack:
        # merged short rows: reindex the dead tracks' observations across
        # the slide (old window slot k+1 -> new slot k)
        sh_obs = torch.cat([frame.short_obs[:, :, 1:], torch.zeros_like(frame.short_obs[:, :, :1])], 2)
        sh_mask = torch.cat(
            [frame.short_mask[:, :, 1:], torch.zeros_like(frame.short_mask[:, :, :1])], 2
        ) & frame.short_valid[..., None]
        stack_obs = torch.cat([frame.msckf_obs, sh_obs], dim=1)
        stack_mask = torch.cat([frame.msckf_mask, sh_mask], dim=1)
    else:
        stack_obs, stack_mask = frame.msckf_obs, frame.msckf_mask
    k_ms = stack_obs.shape[1]

    # ---------------- 3. IEKF loop: stacked update -------------------------
    correction_total = torch.zeros((cov.shape[0], d), dtype=dtype, device=dev)
    new_mask_ms = frame.new_mask & frame.new_is_msckf[..., None]
    for it in range(cfg.iekf_iter):
        # iterations > 0 keep the it-0 measurement model frozen (triangulated
        # point, projector, Jacobians, gates); only residuals move
        if it:
            timing.stamp("rows", cov)
        if it == 0:
            # one GN-triangulation chain for both track families
            all_obs = torch.cat([stack_obs, frame.new_obs], dim=1)
            all_mask = torch.cat([stack_mask, new_mask_ms], dim=1)
            ivd_all, anchor_all = triangulate_gn(
                all_obs, all_mask, vision.q_arr, vision.p_arr, max_iter=cfg.tri_max_iter
            )
            anc = anchor_all[:, :k_ms].long()
            ara = torch.arange(anc.shape[0], device=dev)[:, None]
            world_ms = ivd_to_world(ivd_all[:, :k_ms], vision.q_arr[ara, anc], vision.p_arr[ara, anc])
            fixed_tri = (ivd_all[:, k_ms:], anchor_all[:, k_ms:])
        else:
            world_ms = ms_info.world
            fixed_tri = (ms_init.features, ms_init.anchor)
        msckf_rows, ms_info = msckf.build(
            stack_obs, stack_mask, vision.q_arr, vision.p_arr, cov, cfg.sigma_img, n,
            oc=cfg.obs_constrained, fixed_world=world_ms,
        )
        mslam_rows, ms_init = msckf_slam.build(
            frame.new_obs, new_mask_ms, vision.q_arr, vision.p_arr, cov, cfg.sigma_img, n,
            fixed_tri=fixed_tri,
        )
        slam_rows = slam.build(
            vision.f_arr, vision.anchor_idx, vision.q_arr, vision.p_arr, slam_z,
            slam_has_obs, torch.clamp(slam_len, max=m), cov, cur_pose_idx, cfg.sigma_img,
        )
        rows = [msckf_rows, mslam_rows, slam_rows]
        if cfg.enable_range:
            # LRF facet: the least-area triangle of SLAM features around the
            # LRF image point
            facet_ids, facet_found = feature_triangle_at_point(
                slam_z, slam_has_obs, meas.range_img_pt
            )
            rows.append(range_upd.build(
                meas.range_value, meas.range_img_pt, facet_ids, vision.f_arr,
                vision.anchor_idx, vision.q_arr, vision.p_arr, cov, cur_pose_idx,
                cfg.sigma_range, meas.range_active & facet_found,
            ))
        else:
            facet_ids = torch.full((cov.shape[0], 3), -1, dtype=torch.int32, device=dev)
            facet_found = torch.zeros((cov.shape[0],), dtype=torch.bool, device=dev)
        if cfg.enable_sun:
            rows.append(solar.build(meas.sun_angles, core.q, cov, meas.sun_active))
        jac = torch.cat([r.jac for r in rows], dim=1)
        res = torch.cat([r.res for r in rows], dim=1)
        std = torch.cat([r.noise_std for r in rows], dim=1)
        have_any = (res != 0.0).any(1) | (jac != 0.0).any(2).any(1)
        timing.stamp("apply", cov)
        corr, cov_upd = _apply_rows(
            cov, jac, res, std, correction_total, cov_update=(it == cfg.iekf_iter - 1)
        )
        # agents with no rows at all skip the update (lax.cond in the reference)
        corr = torch.where(have_any[:, None], corr, 0.0)
        cov = torch.where(have_any[:, None, None], cov_upd, cov)
        core = correct_core(core, corr)
        vision = correct_vision(vision, corr, dims)
        correction_total = correction_total + corr
        correction_last = corr  # increment since the LAST build

    # ---------------- 3b. joint-MSCKF CI on stored matches -----------------
    if store is not None and collab_cfg.use_stored_msckf:
        from ..parallel import match_store as ms_mod
        from .updates import msckf_multi

        joint_obs, joint_mask, joint_valid = joint
        core, vision, cov, n_jm = msckf_multi.apply_joint_msckf_ci_pairs(
            dims, core, vision, cov, joint_obs, joint_mask & joint_valid[..., None], joint_valid,
            *ms_mod.gather_peer_tracks(store, work.msckf_rows, work.msckf_matched),
            work.msckf_matched, cfg.sigma_img, collab_cfg.ci_msckf_w, oc=cfg.obs_constrained,
        )
        n_collab = n_collab + n_jm

    # ---------------- 4. feature initialization ---------------------------
    ms_finite = (
        torch.isfinite(ms_init.h2).all(-1).all(-1)
        & torch.isfinite(ms_init.h1).all(-1).all(-1)
        & torch.isfinite(ms_init.features).all(-1)
    )
    accept_ms = frame.new_valid & frame.new_is_msckf & ms_finite
    accept_std = frame.new_valid & ~frame.new_is_msckf
    accepted = torch.where(frame.new_is_msckf, accept_ms, accept_std)
    n_feat_before = vision.n_valid_features
    vision, cov = sm.init_new_features(
        dims, vision, cov, frame.new_is_msckf, ms_init.h1, ms_init.h2, ms_init.r1,
        ms_init.features, frame.new_obs[:, :, m - 1], accepted,
        # (h1, h2, r1) are the LAST iteration's linearization, so dx is the
        # last increment only
        correction_last, cfg.sigma_img, cfg.rho_0, cfg.sigma_rho_0,
    )
    slots = tm.insert_new_slam_tracks(slots, frame, accepted, n_feat_before)
    out = (core, vision, cov, slots)
    if store is not None:
        out = out + (store, n_collab)
    if not return_debug:
        return out
    ara = torch.arange(cov.shape[0], device=dev)[:, None]
    anc = vision.anchor_idx.long()
    debug = FrameDebug(
        msckf_cur=_last_obs(frame.msckf_obs, frame.msckf_mask),
        msckf_inlier=ms_info.inlier[:, : frame.msckf_obs.shape[1]] & frame.msckf_valid,
        msckf_valid=frame.msckf_valid,
        short_cur=_last_obs(frame.short_obs, frame.short_mask),
        short_valid=frame.short_valid,
        slam_cur=slam_z,
        slam_valid=slam_has_obs,
        new_cur=frame.new_obs[:, :, m - 1],
        new_valid=frame.new_valid,
        new_is_msckf=frame.new_is_msckf,
        opp_cur=slots.opp_obs[:, :, m - 1],
        opp_valid=slots.opp_mask[:, :, m - 1] & (slots.opp_id >= 0),
        slam_cartesian=ivd_to_world(vision.f_arr, vision.q_arr[ara, anc], vision.p_arr[ara, anc]),
        slam_cart_valid=vision.feature_mask(dims),
        facet_ids=facet_ids,
        facet_found=facet_found,
    )
    return out + (debug,)


def _consume_stored(cfg: VioConfig, ccfg, core, vision, cov, slots, frame, store):
    """The store's pre-management step: harvest this frame's match work,
    apply the stored SLAM-SLAM upgrades (feature indices are pre-compaction,
    aligned with the current vision state) and the matched dead tracks'
    joint short CI (pre-slide pose list), and take the matched rows out of
    the solo short and MSCKF sets. Returns (store, work, frame, (joint MSCKF
    obs, mask, valid), n_collab, core, vision, cov)."""
    from ..parallel import match_store as ms_mod
    from .updates import msckf_multi, multi_slam

    dims = cfg.dims
    store, work = ms_mod.update_and_harvest(store, slots, frame, ccfg.max_peers)
    n_collab = torch.zeros_like(vision.n_valid_features)
    if ccfg.use_stored_slam:
        ss_own, ss_peer, ss_p, ss_q, ss_f, ss_a, ss_cov, ss_ok = ms_mod.gather_peer_slam(store, work)
        core, vision, cov, n_ss, _ = multi_slam.apply_matches_pairs(
            dims, core, vision, cov, ss_p, ss_q, ss_f, ss_a, ss_cov, ss_own, ss_peer, ss_ok,
            ccfg.sigma_landmark, ccfg.ci_slam_w,
        )
        n_collab = n_collab + n_ss
    if ccfg.use_stored_shortci:
        short_any = work.short_matched.any(-1)
        core, vision, cov, n_sj = msckf_multi.apply_joint_msckf_ci_pairs(
            dims, core, vision, cov, frame.short_obs, frame.short_mask & short_any[..., None],
            frame.short_valid & short_any,
            *ms_mod.gather_peer_tracks(store, work.short_rows, work.short_matched),
            work.short_matched, cfg.sigma_img, ccfg.ci_msckf_w, oc=cfg.obs_constrained,
        )
        n_collab = n_collab + n_sj
    else:
        short_any = torch.zeros_like(frame.short_valid)
    msckf_any = (work.msckf_matched.any(-1) if ccfg.use_stored_msckf
                 else torch.zeros_like(frame.msckf_valid))
    joint = (frame.msckf_obs, frame.msckf_mask, frame.msckf_valid & msckf_any)
    frame = dataclasses.replace(
        frame,
        short_valid=frame.short_valid & ~short_any,
        short_mask=frame.short_mask & ~short_any[..., None],
        msckf_valid=frame.msckf_valid & ~msckf_any,
        msckf_mask=frame.msckf_mask & ~msckf_any[..., None],
    )
    return store, work, frame, joint, n_collab, core, vision, cov

