"""Track classification & bookkeeping as fixed-shape tensor ops (port of
``x_multi_agent_tpu.vio.track_manager``).

SLAM tracks live in N slots aligned 1:1 with the filter's feature states;
opportunistic tracks live in a K-slot pool keyed by a stable track id;
per-frame classes (MSCKF / short-MSCKF / new-SLAM) are emitted into fixed
budgets. Observation storage is window-aligned: obs slot m belongs to window
pose slot m; live tracks shift left each frame and the new observation lands
in slot M-1, while dead tracks keep the pre-shift alignment (what the
short-MSCKF rows need).

Every tensor carries a leading agent axis A.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import resolve
from ..ops import lie
from ..utils.tree import scatter_dump, take, topk_stable


class TrackDims(NamedTuple):
    n_slam: int = 15  # == StateDims.n_features
    n_poses: int = 15  # == StateDims.n_poses (M)
    n_opp: int = 60  # opportunistic pool slots
    n_matches: int = 200  # per-frame match budget
    n_msckf: int = 10  # MSCKF tracks per frame budget
    n_short: int = 10  # short-MSCKF tracks per frame budget
    n_new_slam: int = 15  # new SLAM features per frame budget (<= n_slam)
    # image tile grid for SLAM-feature spatial spreading; 0 x 0 disables it
    n_tiles_h: int = 0
    n_tiles_w: int = 0


@dataclass(frozen=True)
class TrackSlots:
    """Persistent track storage, (A, ...) per field."""

    slam_obs: torch.Tensor  # (A, N, M, 2)
    slam_mask: torch.Tensor  # (A, N, M) bool
    slam_id: torch.Tensor  # (A, N) int32, -1 = inactive
    slam_length: torch.Tensor  # (A, N) int32 total obs count (chi2 dof)
    opp_obs: torch.Tensor  # (A, K, M, 2)
    opp_mask: torch.Tensor  # (A, K, M)
    opp_id: torch.Tensor  # (A, K)
    opp_length: torch.Tensor  # (A, K)
    slam_desc: torch.Tensor  # (A, N, 32) uint8 last-obs descriptor
    slam_desc_valid: torch.Tensor  # (A, N)
    opp_desc: torch.Tensor  # (A, K, 32) uint8
    opp_desc_valid: torch.Tensor  # (A, K)
    slam_tile: torch.Tensor  # (A, N) int32 tile of last obs (-1 unknown)
    opp_tile: torch.Tensor  # (A, K) int32

    @staticmethod
    def zero(dims: TrackDims, a: int, dtype=torch.float32, device=None) -> "TrackSlots":
        n, m, k = dims.n_slam, dims.n_poses, dims.n_opp
        device = resolve(device)
        i32 = dict(dtype=torch.int32, device=device)
        return TrackSlots(
            slam_obs=torch.zeros((a, n, m, 2), dtype=dtype, device=device),
            slam_mask=torch.zeros((a, n, m), dtype=torch.bool, device=device),
            slam_id=torch.full((a, n), -1, **i32),
            slam_length=torch.zeros((a, n), **i32),
            opp_obs=torch.zeros((a, k, m, 2), dtype=dtype, device=device),
            opp_mask=torch.zeros((a, k, m), dtype=torch.bool, device=device),
            opp_id=torch.full((a, k), -1, **i32),
            opp_length=torch.zeros((a, k), **i32),
            slam_desc=torch.zeros((a, n, 32), dtype=torch.uint8, device=device),
            slam_desc_valid=torch.zeros((a, n), dtype=torch.bool, device=device),
            opp_desc=torch.zeros((a, k, 32), dtype=torch.uint8, device=device),
            opp_desc_valid=torch.zeros((a, k), dtype=torch.bool, device=device),
            slam_tile=torch.full((a, n), -1, **i32),
            opp_tile=torch.full((a, k), -1, **i32),
        )


@dataclass(frozen=True)
class Matches:
    """Per-frame feature matches in normalized undistorted coordinates,
    (A, J, ...) per field. ``track_id`` is stable across frames; a match whose
    id is in no live track starts a new opportunistic track."""

    track_id: torch.Tensor  # (A, J) int32
    prev_pt: torch.Tensor  # (A, J, 2)
    cur_pt: torch.Tensor  # (A, J, 2)
    valid: torch.Tensor  # (A, J) bool
    desc: torch.Tensor  # (A, J, 32) uint8 binary descriptor of the current obs
    desc_valid: torch.Tensor  # (A, J) bool
    tile: torch.Tensor  # (A, J) int32 image tile of the current obs (-1 n/a)
    level: torch.Tensor  # (A, J) int32 pyramid level at detection

    @staticmethod
    def zero(dims: TrackDims, a: int, dtype=torch.float32, device=None) -> "Matches":
        j = dims.n_matches
        device = resolve(device)
        return Matches.of(
            track_id=torch.full((a, j), -1, dtype=torch.int32, device=device),
            prev_pt=torch.zeros((a, j, 2), dtype=dtype, device=device),
            cur_pt=torch.zeros((a, j, 2), dtype=dtype, device=device),
            valid=torch.zeros((a, j), dtype=torch.bool, device=device),
        )

    @staticmethod
    def of(track_id, prev_pt, cur_pt, valid, desc=None, desc_valid=None, tile=None,
           level=None) -> "Matches":
        """Matches from ids and points; descriptors, tiles and levels
        default to none (zeros, tile -1, level 0)."""
        shape, dev = track_id.shape, track_id.device
        if desc is None:
            desc = torch.zeros(shape + (32,), dtype=torch.uint8, device=dev)
            desc_valid = torch.zeros(shape, dtype=torch.bool, device=dev)
        if tile is None:
            tile = torch.full(shape, -1, dtype=torch.int32, device=dev)
        if level is None:
            level = torch.zeros(shape, dtype=torch.int32, device=dev)
        return Matches(track_id, prev_pt, cur_pt, valid, desc, desc_valid, tile, level)


@dataclass(frozen=True)
class FrameTracks:
    """Per-frame classified measurement sets (fixed budgets), (A, ...)."""

    slam_has_obs: torch.Tensor  # (A, N)
    lost_slam: torch.Tensor  # (A, N) active slots that died this frame
    msckf_obs: torch.Tensor  # (A, Km, M, 2) post-shift alignment
    msckf_mask: torch.Tensor
    msckf_valid: torch.Tensor
    msckf_id: torch.Tensor
    short_obs: torch.Tensor  # (A, Ks, M, 2) PRE-shift alignment (old window)
    short_mask: torch.Tensor
    short_valid: torch.Tensor
    short_id: torch.Tensor
    new_obs: torch.Tensor  # (A, Kn, M, 2) MSCKF-SLAM group first, then std
    new_mask: torch.Tensor
    new_valid: torch.Tensor
    new_is_msckf: torch.Tensor
    new_id: torch.Tensor
    new_length: torch.Tensor
    new_desc: torch.Tensor
    new_desc_valid: torch.Tensor
    new_tile: torch.Tensor


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def stable_partition(keep: torch.Tensor) -> torch.Tensor:
    """Stable permutation (A, n) int32 putting kept slots first."""
    n = keep.shape[-1]
    k = keep.to(torch.int64)
    n_keep = k.sum(-1, keepdim=True)
    pos = torch.where(keep, torch.cumsum(k, -1) - 1, n_keep + torch.cumsum(1 - k, -1) - 1)
    src = torch.arange(n, dtype=torch.int32, device=keep.device).expand(keep.shape)
    return torch.zeros_like(src).scatter(-1, pos, src)


compaction_perm = stable_partition


def _select_budget(mask: torch.Tensor, order_key: torch.Tensor, budget: int):
    """Pick up to ``budget`` slots per agent where mask, highest order_key
    first (ties to the lower slot). Returns (indices (A,budget), valid)."""
    n = mask.shape[-1]
    neg = torch.full(mask.shape, float("-inf"), dtype=torch.float32, device=mask.device)
    key = torch.where(mask, order_key.to(torch.float32), neg)
    key = key - torch.arange(n, dtype=torch.float32, device=mask.device) * (1.0 / (2.0 * n))
    _, idx = topk_stable(key, budget)
    return idx.to(torch.int32), torch.gather(mask, -1, idx)


def check_baseline(
    obs: torch.Tensor,  # (A, K, M, 2)
    mask: torch.Tensor,  # (A, K, M)
    q_list: torch.Tensor,  # (A, M, 4) camera attitudes, window-aligned
    last_idx: int,  # index of the reference (last) pose/obs
    min_baseline_x: float,
    min_baseline_y: float,
):
    """Rotation-compensated normalized-coordinate spread test (A, K)."""
    q_n = q_list[:, last_idx]
    q_rel = lie.quat_multiply(lie.quat_conjugate(q_list), q_n[:, None])  # (A, M, 4)
    r_rel = lie.quat_to_rot(q_rel)
    rays = torch.cat([obs, torch.ones_like(obs[..., :1])], -1)
    rot = torch.einsum("amji,akmj->akmi", r_rel, rays)  # R^T @ ray
    z = rot[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    xy = rot[..., :2] / safe_z[..., None]
    inf = torch.full_like(xy[..., 0], float("inf"))
    x = torch.where(mask, xy[..., 0], inf)
    y = torch.where(mask, xy[..., 1], inf)
    dx = torch.amax(torch.where(mask, xy[..., 0], -inf), -1) - torch.amin(x, -1)
    dy = torch.amax(torch.where(mask, xy[..., 1], -inf), -1) - torch.amin(y, -1)
    return (dx > min_baseline_x) | (dy > min_baseline_y)


def _spread_scan(n_bins, slam_tile, slam_alive, cand_tile, cand_valid, n_slam_free):
    """Per-tile SLAM-feature spreading with eviction, a sequential pass over
    the (length-sorted) promotion candidates, batched over agents.

    Per candidate: promote into a free slot if any; else, if the fullest
    bin holds >= 2 more features than the candidate's bin, evict the
    youngest feature of that bin (a candidate accepted this frame first,
    else the newest existing SLAM track) and take its slot; else reject.
    Returns (accept (A, Kc), evict (A, N))."""
    a, n = slam_tile.shape
    kc = cand_tile.shape[1]
    dev = slam_tile.device
    ar = torch.arange(a, device=dev)
    bins = torch.arange(n_bins, dtype=torch.int32, device=dev)
    counts = torch.sum(
        (slam_tile[:, None, :] == bins[None, :, None]) & slam_alive[:, None, :], dim=2
    ).to(torch.int32)
    free = n_slam_free.to(torch.int32).clone()
    accept = torch.zeros((a, kc), dtype=torch.bool, device=dev)
    evict = torch.zeros((a, n), dtype=torch.bool, device=dev)
    kc_ar = torch.arange(kc, device=dev)
    n_ar = torch.arange(n, device=dev)
    for t in range(kc):
        bt = torch.clamp(cand_tile[:, t], 0, n_bins - 1).long()
        valid = cand_valid[:, t] & (cand_tile[:, t] >= 0)
        maxbin = torch.argmax(counts, dim=1)
        maxcount = counts[ar, maxbin]
        take_free = valid & (free > 0)
        can_evict = valid & (free <= 0) & (maxcount > counts[ar, bt] + 1)
        acc_in_max = accept & (cand_tile == maxbin[:, None])
        has_new = acc_in_max.any(1)
        new_j = torch.argmax(torch.where(acc_in_max, kc_ar, -1), dim=1)
        slam_in_max = slam_alive & ~evict & (slam_tile == maxbin[:, None])
        old_j = torch.argmax(torch.where(slam_in_max, n_ar, -1), dim=1)
        has_old = slam_in_max.any(1)
        do_evict = can_evict & (has_new | has_old)
        accept = accept.clone()
        accept[ar, new_j] = torch.where(do_evict & has_new, False, accept[ar, new_j])
        evict = evict.clone()
        evict[ar, old_j] = torch.where(do_evict & ~has_new & has_old, True, evict[ar, old_j])
        counts = counts.clone()
        counts[ar, maxbin] += torch.where(do_evict, -1, 0).to(torch.int32)
        took = take_free | do_evict
        accept[:, t] = took
        counts[ar, bt] += took.to(torch.int32)
        free = free - take_free.to(torch.int32)
    return accept, evict


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Slide window-aligned (A, S, M, ...) slots left by one pose."""
    return torch.cat([x[:, :, 1:], torch.zeros_like(x[:, :, :1])], dim=2)


def _set_last(x: torch.Tensor, value) -> torch.Tensor:
    out = x.clone()
    out[:, :, -1] = value
    return out


def _first_hit(hit: torch.Tensor) -> torch.Tensor:
    """argmax of a boolean (A, S, J) along J: the first True (0 if none)."""
    return torch.argmax(hit.to(torch.uint8), dim=2)


# ---------------------------------------------------------------------------
# main per-frame classification
# ---------------------------------------------------------------------------


def manage_tracks(
    dims: TrackDims,
    slots: TrackSlots,
    matches: Matches,
    q_list_old: torch.Tensor,  # (A, M, 4) pre-slide cam attitudes
    q_cur: torch.Tensor,  # (A, 4) current camera attitude (world<-cam)
    min_track_length: int,
    min_baseline_x: float,
    min_baseline_y: float,
    prev_pose_valid: torch.Tensor,  # (A,) bool
):
    """One frame of track bookkeeping.

    ``q_list_old`` is the pre-slide window attitude list; the baseline checks
    use [old slots 1..M-1] + current attitude. Returns (new_slots,
    FrameTracks, slam_current_obs (A, N, 2))."""
    n, m, k = dims.n_slam, dims.n_poses, dims.n_opp
    dtype = slots.slam_obs.dtype
    dev = slots.slam_obs.device
    a = slots.slam_id.shape[0]
    bool_ak = lambda: torch.zeros((a, k), dtype=torch.bool, device=dev)

    mid = torch.where(matches.valid, matches.track_id, torch.full_like(matches.track_id, -2))
    q_list_new = torch.cat([q_list_old[:, 1:], q_cur[:, None]], dim=1)

    # ---------------- SLAM tracks ----------------
    slam_active = slots.slam_id >= 0
    slam_hit = slots.slam_id[:, :, None] == mid[:, None, :]  # (A, N, J)
    slam_found = slam_hit.any(2) & slam_active
    slam_match_idx = _first_hit(slam_hit)
    slam_new_pt = take(matches.cur_pt, slam_match_idx)
    slam_obs_new = _set_last(_shift(slots.slam_obs), slam_new_pt)
    slam_mask_new = _set_last(_shift(slots.slam_mask), True)

    lost_slam = slam_active & ~slam_found
    slam_obs2 = torch.where(slam_found[..., None, None], slam_obs_new, slots.slam_obs)
    slam_mask2 = torch.where(slam_found[..., None], slam_mask_new, slots.slam_mask)
    slam_len2 = slots.slam_length + slam_found.to(torch.int32)
    upd_desc = slam_found & take(matches.desc_valid, slam_match_idx)
    slam_desc2 = torch.where(upd_desc[..., None], take(matches.desc, slam_match_idx), slots.slam_desc)
    slam_desc_valid2 = torch.where(upd_desc, True, slots.slam_desc_valid & slam_found)
    m_tile = take(matches.tile, slam_match_idx)
    slam_tile2 = torch.where(slam_found & (m_tile >= 0), m_tile, slots.slam_tile)

    consumed_by_slam = (slam_hit & slam_active[:, :, None]).any(1)  # (A, J)

    # ---------------- opportunistic tracks ----------------
    opp_active = slots.opp_id >= 0
    opp_eq = slots.opp_id[:, :, None] == mid[:, None, :]
    opp_hit = opp_eq & ~consumed_by_slam[:, None, :]
    opp_found = opp_hit.any(2) & opp_active
    opp_match_idx = _first_hit(opp_hit)
    opp_new_pt = take(matches.cur_pt, opp_match_idx)
    opp_dead = opp_active & ~opp_found

    # short-MSCKF: dead tracks with >= 2 obs and baseline over the old list
    short_baseline = check_baseline(
        slots.opp_obs, slots.opp_mask, q_list_old, m - 1, min_baseline_x, min_baseline_y
    )
    short_cand = opp_dead & (slots.opp_length >= 2) & short_baseline
    short_idx, short_valid = _select_budget(short_cand, slots.opp_length.to(dtype), dims.n_short)
    short_obs = take(slots.opp_obs, short_idx)
    short_mask = take(slots.opp_mask, short_idx) & short_valid[..., None]
    short_id = torch.where(short_valid, take(slots.opp_id, short_idx), -1)

    # live opp tracks: shift + append current obs
    opp_obs2 = torch.where(
        opp_found[..., None, None], _set_last(_shift(slots.opp_obs), opp_new_pt),
        torch.zeros_like(slots.opp_obs),
    )
    opp_mask2 = torch.where(opp_found[..., None], _set_last(_shift(slots.opp_mask), True), False)
    opp_id2 = torch.where(opp_found, slots.opp_id, -1)
    opp_len2 = torch.where(opp_found, slots.opp_length + 1, 0).to(torch.int32)
    upd_odesc = opp_found & take(matches.desc_valid, opp_match_idx)
    opp_desc2 = torch.where(upd_odesc[..., None], take(matches.desc, opp_match_idx), slots.opp_desc)
    opp_desc_valid2 = torch.where(upd_odesc, True, slots.opp_desc_valid & opp_found)
    o_tile = take(matches.tile, opp_match_idx)
    opp_tile2 = torch.where(opp_found & (o_tile >= 0), o_tile, slots.opp_tile)

    # new opportunistic tracks from unconsumed matches, paired with free slots
    match_known = consumed_by_slam | (opp_eq & opp_active[:, :, None]).any(1)
    is_new_match = matches.valid & ~match_known & (matches.track_id >= 0)
    free_slot = ~opp_found
    new_rank = torch.cumsum(is_new_match.to(torch.int64), dim=1) - 1  # (A, J)
    free_idx = stable_partition(free_slot)
    n_free = torch.sum(free_slot, dim=1, keepdim=True)
    can_place = is_new_match & (new_rank < n_free)
    target = take(free_idx, torch.clamp(new_rank, 0, k - 1))
    tgt = torch.where(can_place, target.long(), k)

    jm = matches.valid.shape[1]
    new_obs_j = torch.zeros((a, jm, m, 2), dtype=dtype, device=dev)
    new_obs_j[:, :, m - 2] = matches.prev_pt
    new_obs_j[:, :, m - 1] = matches.cur_pt
    new_msk_j = torch.zeros((a, jm, m), dtype=torch.bool, device=dev)
    # the previous observation belongs to the pose at slot M-2 of the
    # post-slide window; drop it if that pose isn't valid yet
    new_msk_j[:, :, m - 2] = prev_pose_valid[:, None]
    new_msk_j[:, :, m - 1] = True
    opp_obs2 = scatter_dump(opp_obs2, tgt, new_obs_j)
    opp_mask2 = scatter_dump(opp_mask2, tgt, new_msk_j)
    opp_id2 = scatter_dump(opp_id2, tgt, matches.track_id)
    opp_len2 = scatter_dump(opp_len2, tgt, torch.full_like(matches.track_id, 2))
    opp_desc2 = scatter_dump(opp_desc2, tgt, matches.desc)
    opp_desc_valid2 = scatter_dump(opp_desc_valid2, tgt, matches.desc_valid)
    opp_tile2 = scatter_dump(opp_tile2, tgt, matches.tile)
    opp_active2 = opp_id2 >= 0

    # ---------------- promotions ----------------
    live_baseline = check_baseline(
        opp_obs2, opp_mask2, q_list_new, m - 1, min_baseline_x, min_baseline_y
    )
    n_slam_free = n - torch.sum(slam_active & ~lost_slam, dim=1)
    long_enough = opp_active2 & (opp_len2 > min_track_length - 1)
    promo_idx, promo_valid = _select_budget(long_enough, opp_len2.to(dtype), dims.n_new_slam)
    n_bins = dims.n_tiles_h * dims.n_tiles_w
    if n_bins > 0:
        accept, evict = _spread_scan(
            n_bins, slam_tile2, slam_active & ~lost_slam, take(opp_tile2, promo_idx),
            promo_valid, n_slam_free,
        )
        promo_valid = accept
        lost_slam = lost_slam | evict
    else:
        ar_new = torch.arange(dims.n_new_slam, device=dev)
        promo_valid = promo_valid & (ar_new < n_slam_free[:, None])

    new_obs = take(opp_obs2, promo_idx)
    new_mask = take(opp_mask2, promo_idx) & promo_valid[..., None]
    new_id = torch.where(promo_valid, take(opp_id2, promo_idx), -1)
    new_length = torch.where(promo_valid, take(opp_len2, promo_idx), 0).to(torch.int32)
    new_is_msckf = take(live_baseline, promo_idx) & promo_valid
    # order: MSCKF-SLAM group first, then std, invalid last
    order = torch.argsort(
        torch.where(promo_valid, (~new_is_msckf).to(torch.int32), 2), dim=1, stable=True
    )
    new_desc = take(opp_desc2, promo_idx)
    new_desc_valid = take(opp_desc_valid2, promo_idx) & promo_valid
    new_tile = torch.where(promo_valid, take(opp_tile2, promo_idx), -1)

    promoted = torch.zeros_like(opp_active2).scatter(1, promo_idx.long(), promo_valid)

    # MSCKF: remaining live tracks spanning the full window + baseline OK
    msckf_cand = opp_active2 & ~promoted & (opp_len2 > m - 1) & live_baseline
    msckf_idx, msckf_valid = _select_budget(msckf_cand, opp_len2.to(dtype), dims.n_msckf)
    msckf_obs = take(opp_obs2, msckf_idx)
    msckf_mask = take(opp_mask2, msckf_idx) & msckf_valid[..., None]
    msckf_id = torch.where(msckf_valid, take(opp_id2, msckf_idx), -1)

    consumed = promoted | bool_ak().scatter(1, msckf_idx.long(), msckf_valid)
    new_slots = TrackSlots(
        slam_obs=slam_obs2,
        slam_mask=slam_mask2,
        slam_id=slots.slam_id,  # lost slots removed by apply_slam_compaction later
        slam_length=slam_len2,
        opp_obs=opp_obs2,
        opp_mask=torch.where(consumed[..., None], False, opp_mask2),
        opp_id=torch.where(consumed, -1, opp_id2),
        opp_length=torch.where(consumed, 0, opp_len2).to(torch.int32),
        slam_desc=slam_desc2,
        slam_desc_valid=slam_desc_valid2,
        opp_desc=opp_desc2,
        opp_desc_valid=torch.where(consumed, False, opp_desc_valid2),
        slam_tile=slam_tile2,
        opp_tile=opp_tile2,
    )
    frame = FrameTracks(
        slam_has_obs=slam_found,
        lost_slam=lost_slam,
        msckf_obs=msckf_obs,
        msckf_mask=msckf_mask,
        msckf_valid=msckf_valid,
        msckf_id=msckf_id,
        short_obs=short_obs,
        short_mask=short_mask,
        short_valid=short_valid,
        short_id=short_id,
        new_obs=take(new_obs, order),
        new_mask=take(new_mask, order),
        new_valid=take(promo_valid, order),
        new_is_msckf=take(new_is_msckf, order),
        new_id=take(new_id, order),
        new_length=take(new_length, order),
        new_desc=take(new_desc, order),
        new_desc_valid=take(new_desc_valid, order),
        new_tile=take(new_tile, order),
    )
    return new_slots, frame, slam_new_pt


def apply_slam_compaction(slots: TrackSlots, perm: torch.Tensor, n_keep) -> TrackSlots:
    """Apply the lost-feature compaction permutation (A, N) to the SLAM track
    slots (mirrors the feature-state/covariance excision)."""
    n = perm.shape[1]
    keep = torch.arange(n, device=perm.device) < n_keep[:, None]
    k3 = keep[..., None]
    return dataclasses.replace(
        slots,
        slam_obs=torch.where(k3[..., None], take(slots.slam_obs, perm), 0.0),
        slam_mask=torch.where(k3, take(slots.slam_mask, perm), False),
        slam_id=torch.where(keep, take(slots.slam_id, perm), -1),
        slam_length=torch.where(keep, take(slots.slam_length, perm), 0).to(torch.int32),
        slam_desc=torch.where(k3, take(slots.slam_desc, perm), 0).to(torch.uint8),
        slam_desc_valid=torch.where(keep, take(slots.slam_desc_valid, perm), False),
        slam_tile=torch.where(keep, take(slots.slam_tile, perm), -1),
    )


def insert_new_slam_tracks(slots: TrackSlots, frame: FrameTracks, accepted, n_features_before):
    """Write accepted new-SLAM tracks (A, Kn) into SLAM slots n_before,
    n_before+1, ... in order (the feature-state insertion order)."""
    n = slots.slam_id.shape[1]
    rank = torch.cumsum(accepted.to(torch.int64), dim=1) - 1
    tgt = torch.where(accepted, n_features_before[:, None].long() + rank, n)
    return dataclasses.replace(
        slots,
        slam_obs=scatter_dump(slots.slam_obs, tgt, frame.new_obs),
        slam_mask=scatter_dump(slots.slam_mask, tgt, frame.new_mask),
        slam_id=scatter_dump(slots.slam_id, tgt, frame.new_id),
        slam_length=scatter_dump(slots.slam_length, tgt, frame.new_length),
        slam_desc=scatter_dump(slots.slam_desc, tgt, frame.new_desc),
        slam_desc_valid=scatter_dump(slots.slam_desc_valid, tgt, frame.new_desc_valid),
        slam_tile=scatter_dump(slots.slam_tile, tgt, frame.new_tile),
    )
