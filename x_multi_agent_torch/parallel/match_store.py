"""Persistent cross-agent match store and its upgrade bookkeeping (port of
``x_multi_agent_tpu.parallel.match_store``).

Matches recorded against received payloads wait until the own track is
classified, then are consumed inside a visual update:

  * an own OPP track selected as MSCKF whose peer side is a collaborative
    track -> joint-MSCKF CI;
  * an own OPP track promoted to SLAM whose peer side is a SLAM feature ->
    SLAM-SLAM CI;
  * an own matched track that dies -> joint short-MSCKF CI against the
    pre-slide pose list;
  * matches whose own track is gone from every container are discarded.

Fixed shapes: peer payload snapshots live in a ring of S slots; match slots
are a Q-row table joined against current track ids by masked equality.
Every field carries the leading agent axis A. Writes that must be dropped
go to a sacrificial row that is sliced off (never an out-of-range index).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ekf.state import StateDims, VisionState
from ..utils import tree
from ..utils.tree import scatter_dump, take
from ..vio.track_manager import stable_partition
from .payload import AgentPayload, make_payload

PEER_COLLAB = 1  # peer side is a collaborative (MSCKF/OPP) track
PEER_SLAM = 2  # peer side is a SLAM feature


class StoreDims(NamedTuple):
    n_payloads: int = 4  # peer snapshot ring slots (S)
    n_matches: int = 16  # persistent match slots (Q)
    max_peers: int = 2  # joint-MSCKF peer budget per own track (P)


@dataclass(frozen=True)
class MatchStore:
    """Fixed-shape persistent match state, (A, ...) per field."""

    pay: AgentPayload  # (A, S, ...) peer payload snapshot ring
    pay_uav: torch.Tensor  # (A, S) int32 sender id
    pay_valid: torch.Tensor  # (A, S) bool
    pay_head: torch.Tensor  # (A,) int32 next write slot
    own_id: torch.Tensor  # (A, Q) int32 own track id, -1 = free
    peer_type: torch.Tensor  # (A, Q) int32 PEER_COLLAB | PEER_SLAM
    pay_slot: torch.Tensor  # (A, Q) int32 snapshot holding the peer data
    peer_idx: torch.Tensor  # (A, Q) int32 index into pay.trk_* or pay.f_arr
    uav_id: torch.Tensor  # (A, Q) int32 peer agent id

    @staticmethod
    def zero(dims: StateDims, sdims: StoreDims, a: int, n_collab_tracks: int = 8,
             dtype=torch.float32, device=None) -> "MatchStore":
        s, q = sdims.n_payloads, sdims.n_matches
        one = make_payload(
            dims, torch.zeros((a,), dtype=dtype, device=device),
            VisionState.zero(dims, a, dtype, device),
            torch.zeros((a, dims.d, dims.d), dtype=dtype, device=device),
            n_collab_tracks=n_collab_tracks,
        )

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.int32, device=device)

        return MatchStore(
            pay=tree.map_leaves(
                lambda x: x[:, None].expand((a, s) + x.shape[1:]).contiguous(), one),
            pay_uav=full((a, s), -1),
            pay_valid=torch.zeros((a, s), dtype=torch.bool, device=device),
            pay_head=full((a,), 0),
            own_id=full((a, q), -1),
            peer_type=full((a, q), 0),
            pay_slot=full((a, q), 0),
            peer_idx=full((a, q), 0),
            uav_id=full((a, q), -1),
        )


def _per_agent(x, a: int, dtype, device) -> torch.Tensor:
    """A Python scalar or an (A,) tensor -> an (A,) tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.full((a,), x, dtype=dtype, device=device)


def record(
    store: MatchStore,
    slots,  # track_manager.TrackSlots
    payload: AgentPayload,  # (A, ...) one received payload per agent
    uav_id,  # (A,) or int: sender id
    desc_ratio_thr: float,
    desc_abs_thr: float,
    store_when=True,  # (A,) or bool
    ransac_thr: float = 0.0,
    sampler=None,
) -> MatchStore:
    """Descriptor-match own OPP tracks against a received payload's
    collaborative tracks and SLAM features, gate the matches with an
    epipolar RANSAC (``ransac_thr`` > 0; its sample indices come from
    ``sampler``, keyed like the reference on (11, payload.time, uav_id), see
    ``ops.ransac.generator_sampler``), and merge them into the store.

    Own-SLAM x peer-SLAM matches are not stored: the caller fuses them at
    once (``collab.fuse_with_peer_desc``)."""
    from ..ops.ransac import ransac_inliers
    from ..place_recognition.descriptors import knn2_match

    a = store.own_id.shape[0]
    dev = store.own_id.device
    uav_id = _per_agent(uav_id, a, torch.int32, dev)
    store_when = _per_agent(store_when, a, torch.bool, dev)
    own_id0 = _stale_own_ids(store, store.pay_head, store_when)

    opp_ok = slots.opp_desc_valid & (slots.opp_id >= 0)
    c_idx, c_ok = knn2_match(slots.opp_desc, opp_ok, payload.trk_desc, payload.trk_desc_valid,
                             desc_ratio_thr, desc_abs_thr)
    s_idx, s_ok = knn2_match(slots.opp_desc, opp_ok, payload.slam_desc, payload.slam_desc_valid,
                             desc_ratio_thr, desc_abs_thr)
    # prefer the collaborative-track match when both hit
    s_ok = s_ok & ~c_ok
    cand_type = torch.where(c_ok, PEER_COLLAB, PEER_SLAM).to(torch.int32)
    cand_idx = torch.where(c_ok, c_idx, s_idx)
    cand_ok = (c_ok | s_ok) & store_when[:, None]

    if ransac_thr > 0:
        if sampler is None:
            raise ValueError("the RANSAC gate needs a sampler (ops.ransac.generator_sampler)")
        m = slots.opp_obs.shape[2]
        own_pts = slots.opp_obs[:, :, m - 1]
        # peer side: the matched collaborative track's last valid observation,
        # or the SLAM feature's last observation
        pos = torch.arange(m, device=dev)
        last_slot = torch.argmax(torch.where(payload.trk_mask, pos, -1), dim=-1)
        trk_last = torch.gather(
            payload.trk_obs, 2, last_slot[..., None, None].expand(-1, -1, 1, 2)
        )[:, :, 0]
        peer_pts = torch.where(c_ok[..., None], take(trk_last, c_idx),
                               take(payload.slam_obs, s_idx))
        idx = sampler(cand_ok, 11, payload.time, uav_id)
        cand_ok = cand_ok & ransac_inliers(own_pts, peer_pts, cand_ok, idx, ransac_thr)

    return _merge_candidates(store, payload, uav_id, own_id0, slots.opp_id, cand_type,
                             cand_idx, cand_ok, store_when)


def _stale_own_ids(store: MatchStore, slot, store_when):
    """Invalidate matches that reference the payload ring slot about to be
    overwritten; returns the cleaned own_id column."""
    stale = (store.pay_slot == slot[:, None]) & (store.own_id >= 0) & store_when[:, None]
    return torch.where(stale, -1, store.own_id)


def record_gt(store: MatchStore, slots, payload: AgentPayload, uav_id,
              store_when=True) -> MatchStore:
    """Ground-truth classification of a received payload by global track-id
    equality: own OPP x peer collaborative track -> PEER_COLLAB, own OPP x
    peer SLAM feature -> PEER_SLAM (the first matching peer index wins);
    own SLAM x peer SLAM is not stored."""
    a = store.own_id.shape[0]
    dev = store.own_id.device
    uav_id = _per_agent(uav_id, a, torch.int32, dev)
    store_when = _per_agent(store_when, a, torch.bool, dev)
    own_id0 = _stale_own_ids(store, store.pay_head, store_when)

    opp = slots.opp_id[:, :, None]
    opp_ok = opp >= 0
    c_hit = opp_ok & (opp == payload.trk_id[:, None, :]) & (payload.trk_id[:, None, :] >= 0)
    s_hit = opp_ok & (opp == payload.slam_id[:, None, :]) & (payload.slam_id[:, None, :] >= 0)
    c_ok = c_hit.any(-1)
    s_ok = s_hit.any(-1) & ~c_ok
    c_idx = torch.argmax(c_hit.to(torch.uint8), dim=-1).to(torch.int32)
    s_idx = torch.argmax(s_hit.to(torch.uint8), dim=-1).to(torch.int32)
    cand_type = torch.where(c_ok, PEER_COLLAB, PEER_SLAM).to(torch.int32)
    cand_idx = torch.where(c_ok, c_idx, s_idx)
    cand_ok = (c_ok | s_ok) & store_when[:, None]
    return _merge_candidates(store, payload, uav_id, own_id0, slots.opp_id, cand_type,
                             cand_idx, cand_ok, store_when)


def _merge_candidates(store: MatchStore, payload: AgentPayload, uav_id, own_id0, cand_id,
                      cand_type, cand_idx, cand_ok, store_when) -> MatchStore:
    """Shared tail of :func:`record` / :func:`record_gt`: payload ring write,
    dedup against stored (own_id, uav) pairs, rank-compacted scatter into
    free match rows."""
    q = store.own_id.shape[1]
    s = store.pay_valid.shape[1]
    slot = store.pay_head.long()[:, None]
    when = store_when

    def write(buf, x):
        return tree.put(buf, slot, tree.where(when, x, take(buf, slot[:, 0]))[:, None])

    pay = dataclasses.replace(store.pay, **{
        f.name: write(getattr(store.pay, f.name), getattr(payload, f.name))
        for f in dataclasses.fields(payload)
    })
    pay_uav = write(store.pay_uav, uav_id)
    pay_valid = write(store.pay_valid, torch.ones_like(when))

    # dedup: drop candidates already stored for the same (own_id, uav)
    dup = (
        (own_id0[:, None, :] == cand_id[:, :, None])
        & (store.uav_id[:, None, :] == uav_id[:, None, None])
        & (own_id0[:, None, :] >= 0)
    ).any(-1)
    cand_ok = cand_ok & ~dup

    # scatter candidates into free match rows (rank compaction)
    free = own_id0 < 0
    rank = torch.cumsum(cand_ok.to(torch.int32), dim=1) - 1
    free_idx = stable_partition(free)
    n_free = torch.sum(free, dim=1, keepdim=True)
    can_place = cand_ok & (rank < n_free)
    tgt = torch.where(can_place, take(free_idx, torch.clamp(rank, 0, q - 1)).long(), q)

    def scat(base, rows):
        return scatter_dump(base, tgt, rows.to(base.dtype).expand(tgt.shape))

    return dataclasses.replace(
        store,
        pay=pay,
        pay_uav=pay_uav,
        pay_valid=pay_valid,
        pay_head=torch.where(when, (store.pay_head + 1) % s, store.pay_head).to(torch.int32),
        own_id=scat(own_id0, cand_id),
        peer_type=scat(store.peer_type, cand_type),
        pay_slot=scat(store.pay_slot, store.pay_head[:, None]),
        peer_idx=scat(store.peer_idx, cand_idx),
        uav_id=scat(store.uav_id, uav_id[:, None]),
    )


class HarvestedWork(NamedTuple):
    """Fixed-budget match work emitted for one visual update, (A, ...)."""

    msckf_rows: torch.Tensor  # (A, Km, P) int32 match-table row, -1 = none
    msckf_matched: torch.Tensor  # (A, Km, P) bool
    short_rows: torch.Tensor  # (A, Ks, P) dead-track (short) matches
    short_matched: torch.Tensor  # (A, Ks, P)
    slam_own_idx: torch.Tensor  # (A, Q) int32 own SLAM slot of each row's upgrade
    slam_rows: torch.Tensor  # (A, Q) int32 match-table row
    slam_matched: torch.Tensor  # (A, Q) bool


def update_and_harvest(store: MatchStore, slots, frame, max_peers: int):
    """Join the match table against this frame's track classification
    (``slots`` after ``manage_tracks``, ``frame`` its FrameTracks):

      * rows whose own id is in ``frame.msckf_id`` -> joint-MSCKF work;
      * rows whose own id is in ``frame.short_id`` -> short joint work;
      * rows whose own id is a SLAM slot's and whose peer side is SLAM ->
        SLAM-SLAM work;
      * rows whose own id is a live OPP track (or this frame's SLAM
        promotion) stay; everything else is discarded.

    Consumed rows are freed. Returns (store, HarvestedWork)."""
    a, q = store.own_id.shape
    row_live = (store.own_id >= 0) & take(store.pay_valid, store.pay_slot)

    def join(ids):  # (A, X) ids -> (A, X, Q) hits
        return ((ids[:, :, None] == store.own_id[:, None, :]) & row_live[:, None, :]
                & (ids[:, :, None] >= 0))

    def topk_rows(hit):  # (A, X, Q) -> (A, X, P) rows and matched, lower row first
        h = hit & (store.peer_type[:, None, :] == PEER_COLLAB)
        order = stable_partition(h)[..., :max_peers].long()
        matched = torch.gather(h, -1, order)
        return torch.where(matched, order, -1).to(torch.int32), matched

    msckf_rows, msckf_matched = topk_rows(join(frame.msckf_id))
    short_rows, short_matched = topk_rows(join(frame.short_id))

    slam_hit = join(slots.slam_id) & (store.peer_type[:, None, :] == PEER_SLAM)
    slam_matched = slam_hit.any(1)  # (A, Q)
    slam_own_idx = torch.argmax(slam_hit.to(torch.uint8), dim=1).to(torch.int32)

    consumed = slam_matched
    for rows_m, m_m in ((msckf_rows, msckf_matched), (short_rows, short_matched)):
        tgt = torch.where(m_m, rows_m, q).reshape(a, -1).long()
        hit = torch.zeros((a, q + 1), dtype=torch.bool, device=tgt.device)
        consumed = consumed | hit.scatter(1, tgt, True)[:, :q]

    # still alive: live OPP tracks plus this frame's in-flight SLAM promotions
    alive = ((store.own_id[:, None, :] == slots.opp_id[:, :, None])
             & (slots.opp_id[:, :, None] >= 0)).any(1)
    alive_new = ((store.own_id[:, None, :] == frame.new_id[:, :, None])
                 & (frame.new_id[:, :, None] >= 0)).any(1)
    keep = row_live & (alive | alive_new) & ~consumed
    store = dataclasses.replace(store, own_id=torch.where(keep, store.own_id, -1))
    work = HarvestedWork(
        msckf_rows=msckf_rows, msckf_matched=msckf_matched,
        short_rows=short_rows, short_matched=short_matched,
        slam_own_idx=slam_own_idx,
        slam_rows=torch.arange(q, dtype=torch.int32, device=store.own_id.device).expand(a, q),
        slam_matched=slam_matched,
    )
    return store, work


def gather_peer_tracks(store: MatchStore, rows: torch.Tensor, matched: torch.Tensor):
    """Per own track and peer slot, the peer data of the referenced match
    rows (A, K, P): (p_arr (A,K,P,M,3), q_arr (A,K,P,M,4), pose_cov
    (A,K,P,6M,6M), obs (A,K,P,M,2), mask (A,K,P,M)). An unmatched entry
    reads row 0, whose peer index may be a SLAM feature's: it is clamped to
    the track slots, as the reference's gather clamps it, and masked out."""
    safe = torch.clamp(rows, min=0)
    slot = take(store.pay_slot, safe).long()  # (A, K, P)
    tidx = take(store.peer_idx, safe).long().clamp(0, store.pay.trk_obs.shape[2] - 1)
    ar = torch.arange(slot.shape[0], device=slot.device)[:, None, None]
    return (
        take(store.pay.p_arr, slot),
        take(store.pay.q_arr, slot),
        take(store.pay.pose_cov, slot),
        store.pay.trk_obs[ar, slot, tidx],
        store.pay.trk_mask[ar, slot, tidx] & matched[..., None],
    )


def gather_peer_slam(store: MatchStore, work: HarvestedWork):
    """Per match-table row, the peer data of its SLAM-SLAM upgrade:
    (own_idx (A,Q), peer_feat_idx (A,Q), p_arr (A,Q,M,3), q_arr (A,Q,M,4),
    f_arr (A,Q,N,3), anchor (A,Q,N), lm_cov (A,Q,N,N,3,3), valid (A,Q))."""
    slot = store.pay_slot
    return (
        work.slam_own_idx,
        store.peer_idx,
        take(store.pay.p_arr, slot),
        take(store.pay.q_arr, slot),
        take(store.pay.f_arr, slot),
        take(store.pay.anchor_idx, slot),
        take(store.pay.lm_cov, slot),
        work.slam_matched,
    )
