"""Collaborative (multi-agent) fusion rounds (port of
``x_multi_agent_tpu.parallel.collab``).

Two exchanges, both batched over A agents (the leading axis):

  * the full-map round: every agent snapshots a payload and fuses every
    peer's with ground-truth-style landmark matching, one joint CI update
    per peer at its newest buffer state (:func:`collaborative_round`);
  * the descriptor-driven request-response round: every agent broadcasts a
    small VLAD query; each responder answers each requester with its best
    unserved keyframe above ``pr_score_thr``, and the heavy payload travels
    only on a hit; requesters fuse received keyframes by descriptor matching
    (kNN + ratio, an epipolar RANSAC gate, a pairwise-distance consistency
    gate, a per-peer re-fusion cooldown) and CI
    (:func:`request_response_round`); the joint-MSCKF round fuses long
    opportunistic tracks across agents (:func:`collaborative_msckf_round`);
    and the facade's path keeps a persistent match store that later visual
    updates consume (:func:`receive_and_record`,
    :func:`process_matches_collab`).

Peers (and requesters) are Python loops in which all agents act at once.
The rounds read nothing back to the host. RANSAC sample indices come from a
``sampler``, by default ``ops.ransac.KeyedSampler()``: a draw keyed on the
reference's key material (a salt, the payload time, the receiver's buffer
head or the sender's id), so each agent's draw follows its own state; torch
cannot repeat the reference's ``jax.random`` bits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve
from ..ekf import buffer as rb
from ..ekf import ekf as ekf_mod
from ..ops import linalg
from ..ops.ransac import KeyedSampler, ransac_inliers
from ..place_recognition import database as db_mod
from ..place_recognition.descriptors import knn2_match
from ..place_recognition.gt_matching import match_landmarks
from ..place_recognition.vlad import compute_vlad
from ..utils import graph, timing, tree
from ..utils.tree import take, topk_stable
from ..vio import pipeline
from ..vio.track_manager import stable_partition
from ..vio.updates import msckf_multi, multi_slam
from ..vio.vio import VioParams, frame_measurement, update_report
from . import match_store as ms_mod
from .payload import AgentPayload, make_payload, slam_landmarks_world


class CollabConfig(NamedTuple):
    """The reference's collaboration parameters, with its defaults."""

    sigma_landmark: float = 0.1
    ci_slam_w: float = 0.01  # weight given to the peer; < 0: downhill-only, |w|
    gt_match_dist: float = 0.5  # proximity gate [m]
    match_budget: int = 10  # SLAM-SLAM matches per peer
    # descriptor path (reference pr_desc_* params)
    desc_ratio_thr: float = 0.8
    desc_abs_thr: float = 60.0
    pr_score_thr: float = 0.3  # request-response VLAD score gate
    # epipolar RANSAC gate on descriptor matches, normalized-coordinate
    # units; <= 0 disables
    pr_ransac_thr: float = 0.01
    # pairwise-distance consistency gate on matched SLAM landmarks [m]: each
    # kept match must agree, |d(own_i, own_j) - d(peer_i', peer_j')| < tol,
    # with at least half of the others; <= 0 disables
    geom_consistency_tol: float = 0.0
    ci_msckf_w: float = 0.01  # cross-agent MSCKF CI weight; < 0 optimizes
    max_peers: int = 2  # joint-MSCKF peer budget per track
    # per-round peer budget: each requester consumes its top-K responses by
    # VLAD score (0 = all)
    top_k_peers: int = 0
    # match-store stream switches
    use_stored_slam: bool = True  # stored SLAM-SLAM upgrades
    use_stored_shortci: bool = True  # matched-dead-track joint short CI
    use_stored_msckf: bool = True  # stored joint-MSCKF CI
    record_opp_matches: bool = True  # record OPP matches on receive
    # SLAM-SLAM re-fusion cooldown: skip re-fusing an own landmark against
    # the same peer for this many receives (0 = off), keyed by slam_id
    refuse_cooldown: int = 0


def _buffer_time(fs, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(rb.times(fs.buffer), 1, idx.long()[:, None])[:, 0]


def extract_payload(params: VioParams, fs) -> AgentPayload:
    """Snapshot every agent's anchor-state vision and covariance."""
    return make_payload(params.cfg.dims, _buffer_time(fs, fs.anchor_buf_idx), fs.vision, fs.cov)


def fuse_with_peer(params: VioParams, ccfg: CollabConfig, fs, peer: AgentPayload,
                   peer_valid: torch.Tensor):
    """Every agent fuses its own peer snapshot (``peer`` fields (A, ...),
    ``peer_valid`` (A,)): match landmarks, CI-fuse at the agent's newest
    buffer state (the landmark residual does not depend on the snapshot's
    age), repropagate. Returns (fs, n_applied (A,))."""
    dims = params.cfg.dims

    def update_fn(core, vision, cov, aux):
        own_lm, own_valid = slam_landmarks_world(dims, vision)
        own_idx, other_idx, mvalid = match_landmarks(
            own_lm, own_valid, peer.landmarks, peer.landmark_valid,
            ccfg.gt_match_dist, ccfg.match_budget,
        )
        core, vision, cov, n_app, _ = multi_slam.apply_matches(
            dims, core, vision, cov,
            peer.p_arr, peer.q_arr, peer.f_arr, peer.anchor_idx, peer.lm_cov,
            own_idx, other_idx, mvalid & peer_valid[:, None],
            ccfg.sigma_landmark, ccfg.ci_slam_w,
        )
        return core, vision, cov, aux + n_app

    n0 = torch.zeros_like(fs.head)
    fs, n_applied, _ = ekf_mod.process_update_aux_impl(
        params.ekf_params, fs, _buffer_time(fs, fs.head), update_fn, n0
    )
    return fs, n_applied


def fresh_recency(slots) -> tuple:
    """The re-fusion cooldown state of one peer, nothing fused yet: (last
    fused slam_id (A, N), receive count at that fusion (A, N), receive count
    (A,))."""
    a, n = slots.slam_id.shape
    dev = slots.slam_id.device
    return (
        torch.full((a, n), -1, dtype=torch.int32, device=dev),
        torch.full((a, n), -(10**9), dtype=torch.int32, device=dev),
        torch.zeros((a,), dtype=torch.int32, device=dev),
    )


def _desc_matches(ccfg: CollabConfig, own_desc, own_desc_valid, own_pts, peer: AgentPayload,
                  head, sampler):
    """The gates of a descriptor fusion that read no fused state, per row
    (own leaves (R, N, ...), ``peer`` (R, ...), ``head`` (R,)): kNN(2) with
    the ratio and absolute gates on the SLAM-track descriptors, then, when
    ``pr_ransac_thr > 0``, the epipolar RANSAC over the matched last
    observations ``own_pts`` (normalized coordinates), its indices from
    ``sampler`` keyed on (7, peer.time, head). Every row is gated on its
    own. Returns (other_idx, ok) (R, N)."""
    other_idx, ok = knn2_match(
        own_desc, own_desc_valid, peer.slam_desc, peer.slam_desc_valid,
        ccfg.desc_ratio_thr, ccfg.desc_abs_thr,
    )
    if ccfg.pr_ransac_thr > 0:
        idx = sampler(ok, 7, peer.time, head)
        ok = ok & ransac_inliers(own_pts, take(peer.slam_obs, other_idx), ok, idx,
                                 ccfg.pr_ransac_thr)
    return other_idx, ok


def _consistency_gate(dims, ccfg: CollabConfig, vision, peer: AgentPayload, other_idx, ok):
    """The pairwise-distance consistency gate on the matched SLAM landmarks,
    which reads the fused state (``vision``): each kept match must agree,
    |d(own_i, own_j) - d(peer_i', peer_j')| < tol, with at least half of
    the others (>= 1)."""
    own_lm, own_lm_valid = slam_landmarks_world(dims, vision)
    ok = ok & own_lm_valid & take(peer.landmark_valid, other_idx)
    peer_lm = take(peer.landmarks, other_idx)
    d_own = torch.linalg.norm(own_lm[:, :, None] - own_lm[:, None], dim=-1)
    d_peer = torch.linalg.norm(peer_lm[:, :, None] - peer_lm[:, None], dim=-1)
    n = own_lm.shape[1]
    cons = (
        (torch.abs(d_own - d_peer) < ccfg.geom_consistency_tol)
        & ok[:, None, :] & ok[:, :, None]
        & ~torch.eye(n, dtype=torch.bool, device=ok.device)
    )
    support = torch.sum(cons, dim=2)
    n_ok = torch.sum(ok, dim=1, keepdim=True)
    return ok & (support >= torch.clamp((n_ok - 1) // 2, min=1))


def _budget(ccfg: CollabConfig, ok, other_idx, peer_valid):
    """The first ``match_budget`` surviving matches, per row: (own slots,
    peer slots, valid), each (R, match_budget)."""
    order = stable_partition(ok)[:, : ccfg.match_budget]
    return order, take(other_idx, order), take(ok, order) & peer_valid[:, None]


def _fuse_matches(dims, ccfg: CollabConfig, core, vision, cov, peer: AgentPayload, order,
                  other_sel, mvalid):
    """One joint CI update of the budgeted matches. Returns (core, vision,
    cov, n_applied (A,), applied (A, match_budget))."""
    return multi_slam.apply_matches(
        dims, core, vision, cov,
        peer.p_arr, peer.q_arr, peer.f_arr, peer.anchor_idx, peer.lm_cov,
        order, other_sel, mvalid, ccfg.sigma_landmark, ccfg.ci_slam_w,
    )


def fuse_with_peer_desc(params: VioParams, ccfg: CollabConfig, fs, slots, peer: AgentPayload,
                        peer_valid: torch.Tensor, recency=None, sampler=None):
    """Descriptor-based SLAM-SLAM fusion, every agent against its own peer
    payload (``peer`` (A, ...), ``peer_valid`` (A,)): kNN(2) with the ratio
    and absolute gates on the SLAM-track descriptors, then the enabled
    gates (epipolar RANSAC over the matched last observations, its indices
    from ``sampler`` (default ``KeyedSampler()``) keyed on (7, peer.time,
    fs.head); pairwise-distance
    consistency; the cooldown), then one joint CI update of the first
    ``match_budget`` surviving matches at the newest buffer state.

    ``recency`` (used when ``ccfg.refuse_cooldown > 0``): this peer's state
    from :func:`fresh_recency`. Returns (fs, n_applied (A,), recency')."""
    dims = params.cfg.dims
    use_cooldown = ccfg.refuse_cooldown > 0 and recency is not None
    if recency is None:
        recency = fresh_recency(slots)
    if sampler is None:
        sampler = KeyedSampler()

    def update_fn(core, vision, cov, aux):
        other_idx, ok = _desc_matches(ccfg, slots.slam_desc, slots.slam_desc_valid,
                                      slots.slam_obs[:, :, dims.n_poses - 1], peer, fs.head,
                                      sampler)
        if ccfg.geom_consistency_tol > 0:
            ok = _consistency_gate(dims, ccfg, vision, peer, other_idx, ok)
        rec = aux[1]
        if use_cooldown:
            last_id, last_cnt, cnt = rec
            fresh = (slots.slam_id != last_id) | (cnt[:, None] - last_cnt >= ccfg.refuse_cooldown)
            ok = ok & fresh
        order, other_sel, mvalid = _budget(ccfg, ok, other_idx, peer_valid)
        core, vision, cov, n_app, applied = _fuse_matches(dims, ccfg, core, vision, cov, peer,
                                                          order, other_sel, mvalid)
        if use_cooldown:
            last_id = tree.put(last_id, order, torch.where(
                applied, take(slots.slam_id, order), take(last_id, order)))
            last_cnt = tree.put(last_cnt, order, torch.where(
                applied, cnt[:, None], take(last_cnt, order)))
            rec = (last_id, last_cnt, cnt)
        return core, vision, cov, (aux[0] + n_app, rec)

    # current-state fusion: a served keyframe's snapshot is stale by
    # construction; the landmark residual does not depend on its time
    fs, (n_applied, recency1), _ = ekf_mod.process_update_aux_impl(
        params.ekf_params, fs, _buffer_time(fs, fs.head), update_fn,
        (torch.zeros_like(fs.head), recency),
    )
    return fs, n_applied, recency1


def fuse_chain_desc(params: VioParams, ccfg: CollabConfig, fs, slots, kf_by_req: AgentPayload,
                    sel: torch.Tensor, sel_valid: torch.Tensor, sampler=None):
    """Every requester fuses its K responses in order: the result of K calls
    of :func:`fuse_with_peer_desc` (no cooldown) in a row, call k against
    ``kf_by_req[sel[:, k], r]`` for requester r, bit for bit, with only
    what reads the fused state inside the chain.

    ``kf_by_req``: the responses, leaves (P responders, A requesters, ...);
    ``sel`` (A, K) each requester's responders in fusion order, ``sel_valid``
    (A, K) which of them carry a hit.

    Each call measures at the buffer head's time, so its slot, its window
    and the anchor's move there are the first call's, and every later call
    would propagate the covariance by an identity and re-propagate a tail
    the next call overwrites. So, once before the chain: the slot, the
    window and the covariance propagated to the slot; over all A x K pairs
    at once, the gates that read no fused state (kNN, RANSAC). The chain,
    k = 0..K-1: the consistency gate (``geom_consistency_tol > 0``, it
    reads the fused landmarks), the budget, the joint CI update, agents
    outside the window held at their start. Once after it: the write-back
    and the tail.

    With the recorder on, tallies ``round_propagated`` (the requesters in
    the window whose anchor lay behind the slot). Returns (fs, n_matches
    (A, K))."""
    dims = params.cfg.dims
    a, k = sel.shape
    if k == 0:
        return fs, torch.zeros((a, 0), dtype=torch.int32, device=sel.device)
    if sampler is None:
        sampler = KeyedSampler()
    b = sel.long()
    rows = torch.arange(a, device=b.device)[:, None]

    def pair(x):  # (P, A, ...) -> (A, K, ...): requester r's k-th response
        return x[b, rows]

    def flat(x):
        return x.reshape((a * k,) + x.shape[2:])

    def rep(x):
        return flat(x[:, None].expand((a, k) + x.shape[1:]))

    def unflat(x):
        return x.reshape((a, k) + x.shape[1:])

    ekf_p = params.ekf_params
    idx, in_window, cov0 = ekf_mod.update_window(ekf_p, fs, _buffer_time(fs, fs.head))
    timing.tally("round_propagated",
                 in_window & (rb.steps_between(fs.anchor_buf_idx, idx, dims.buffer_size) > 0))

    peers = tree.map_leaves(pair, kf_by_req)
    other_idx, ok = _desc_matches(ccfg, rep(slots.slam_desc), rep(slots.slam_desc_valid),
                                  rep(slots.slam_obs[:, :, dims.n_poses - 1]),
                                  tree.map_leaves(flat, peers), rep(fs.head), sampler)
    other_idx, ok = unflat(other_idx), unflat(ok)

    start = (rb.get_slot(fs.buffer, idx), fs.vision, cov0)
    carry = start
    ns = []
    for j in range(k):
        peer = tree.map_leaves(lambda x: x[:, j], peers)
        ok_j = ok[:, j]
        if ccfg.geom_consistency_tol > 0:
            ok_j = _consistency_gate(dims, ccfg, carry[1], peer, other_idx[:, j], ok_j)
        step = _budget(ccfg, ok_j, other_idx[:, j], sel_valid[:, j])
        core, vision, cov, n_app, _ = _fuse_matches(dims, ccfg, *carry, peer, *step)
        carry = tree.where(in_window, (core, vision, cov), start)
        ns.append(n_app)
    fs = ekf_mod.close_update(ekf_p, fs, idx, in_window, *carry)
    return fs, torch.where(in_window[:, None], torch.stack(ns, dim=1), 0)


def collaborative_round(params: VioParams, ccfg: CollabConfig, fs):
    """One full-map exchange round for A agents. Every agent fuses every
    peer's payload in peer order (its own, masked, included, as the
    reference does). Returns (fs, n_matches (A, A)): entry [a, b] counts the
    matches agent a fused from agent b.

    On CUDA tensors raises if TF32 matmuls are on."""
    linalg.require_fp32_matmul(fs.cov.device, "collaborative_round")
    payloads = extract_payload(params, fs)
    a = fs.cov.shape[0]
    ids = torch.arange(a, device=fs.cov.device)
    ns = []
    for b in range(a):
        peer = tree.map_leaves(lambda x: x[b].expand((a,) + x.shape[1:]), payloads)
        fs, n = fuse_with_peer(params, ccfg, fs, peer, ids != b)
        ns.append(n)
    return fs, torch.stack(ns, dim=1)


def collaborative_round_fn(params: VioParams, ccfg: CollabConfig) -> graph.Compiled:
    """:func:`collaborative_round` compiled, the reference's
    ``collaborative_round_jit``: one CUDA graph per call on the card, ``fs``
    the carry (``utils/graph.py``: the returned state and counts are the
    program's buffers, valid until its next call). Each caller keeps its
    own program. ``fs -> (fs, n_matches (A, A))``."""
    return graph.compiled(lambda fs: collaborative_round(params, ccfg, fs), "collaborative_round",
                          n_carry=1)


def collaborative_msckf_round(params: VioParams, ccfg: CollabConfig, fs, slots):
    """Cross-agent joint-MSCKF CI round: each agent's longest opportunistic
    tracks (its own payload's collaborative set) are descriptor-matched
    against the collaborative sets of its first ``max_peers`` peers (in id
    order, itself excluded), jointly triangulated and CI-fused at its
    payload's time. Track validity stands in for the own MSCKF gate.
    Returns (fs, n_applied (A,)). Raises on CUDA if TF32 matmuls are on."""
    linalg.require_fp32_matmul(fs.cov.device, "collaborative_msckf_round")
    a = fs.cov.shape[0]
    dev = fs.cov.device
    own = extract_payload_desc(params, fs, slots)
    ar = torch.arange(a, device=dev)
    key = torch.where(ar[None, :] == ar[:, None], a + 1, ar[None, :])
    peer_ids = torch.argsort(key, dim=1)[:, : ccfg.max_peers]  # (A, P)
    peer_valid = peer_ids != ar[:, None]
    peer = tree.map_leaves(lambda x: x[peer_ids], own)  # (A, P, ...)

    def update_fn(core, vision, cov, aux):
        core, vision, cov, n = msckf_multi.apply_joint_msckf_ci(
            params.cfg.dims, core, vision, cov,
            own.trk_obs, own.trk_mask, own.trk_desc_valid, own.trk_desc, own.trk_desc_valid,
            peer.p_arr, peer.q_arr, peer.pose_cov, peer.trk_obs, peer.trk_mask,
            peer.trk_desc, peer.trk_desc_valid, peer_valid,
            params.cfg.sigma_img, ccfg.ci_msckf_w,
            oc=params.cfg.obs_constrained, desc_abs_thr=ccfg.desc_abs_thr,
        )
        return core, vision, cov, aux + n

    fs, n_applied, _ = ekf_mod.process_update_aux_impl(
        params.ekf_params, fs, own.time, update_fn, torch.zeros_like(fs.head)
    )
    return fs, n_applied


# ---------------------------------------------------------------------------
# request-response policy
# ---------------------------------------------------------------------------


def extract_payload_desc(params: VioParams, fs, slots, n_collab_tracks: int = 8) -> AgentPayload:
    """Keyframe payload: the anchor-state snapshot plus the SLAM-track
    descriptors and last observations and, as the collaborative track set,
    the ``n_collab_tracks`` longest opportunistic tracks with valid
    descriptors (lower slot first among equal lengths)."""
    m = params.cfg.dims.n_poses
    opp_ok = (slots.opp_id >= 0) & slots.opp_desc_valid
    key = torch.where(opp_ok, slots.opp_length.to(fs.cov.dtype), float("-inf"))
    sel = topk_stable(key, n_collab_tracks)[1]
    sel_valid = take(opp_ok, sel)
    return make_payload(
        params.cfg.dims, _buffer_time(fs, fs.anchor_buf_idx), fs.vision, fs.cov,
        slam_desc=slots.slam_desc,
        slam_desc_valid=slots.slam_desc_valid,
        slam_obs=slots.slam_obs[:, :, m - 1],
        trk_obs=take(slots.opp_obs, sel),
        trk_mask=take(slots.opp_mask, sel) & sel_valid[..., None],
        trk_desc=take(slots.opp_desc, sel),
        trk_desc_valid=sel_valid,
        n_collab_tracks=n_collab_tracks,
        trk_id=torch.where(sel_valid, take(slots.opp_id, sel), -1),
        slam_id=slots.slam_id,
    )


def should_select_keyframe(params: VioParams, fs, slots, last_kf_pos, frames_since):
    """Keyframe selection heuristic, per agent: more than 10 applied frames
    since the last keyframe, anchor-pose travel over mean scene depth above
    0.15, more than 10 live tracks. The depth averages 1/rho over all N
    feature slots (the reference's ``med_depth`` is that average)."""
    core = rb.get_slot(fs.buffer, fs.anchor_buf_idx)
    vision = fs.vision
    rho = vision.f_arr[..., 2]
    usable = (rho > 1e-3) & vision.feature_mask(params.cfg.dims)
    depth_sum = torch.sum(torch.where(usable, 1.0 / torch.clamp(rho, min=1e-3), 0.0), dim=1)
    med_depth = depth_sum / max(vision.f_arr.shape[1], 1)
    diff = torch.linalg.norm(core.p - last_kf_pos, dim=-1)
    n_tracks = torch.sum(slots.slam_id >= 0, dim=1) + torch.sum(slots.opp_id >= 0, dim=1)
    return (
        (frames_since > 10)
        & (med_depth > 0.0)
        & (diff / torch.clamp(med_depth, min=1e-6) > 0.15)
        & (n_tracks > 10)
    )


class KfMeta(NamedTuple):
    """Keyframe-selection bookkeeping, (A, ...) per field."""

    last_kf_pos: torch.Tensor  # (A, 3)
    frames_since: torch.Tensor  # (A,) int32

    @staticmethod
    def zero(a: int, dtype=torch.float32, device=None) -> "KfMeta":
        device = resolve(device)
        return KfMeta(
            last_kf_pos=torch.zeros((a, 3), dtype=dtype, device=device),
            frames_since=torch.zeros((a,), dtype=torch.int32, device=device),
        )


def maybe_add_keyframe(params: VioParams, db_dims, words: torch.Tensor, fs, slots, db,
                       kf_meta: KfMeta, enabled=True):
    """Post-update keyframe step: evaluate the selection heuristic; where it
    fires (and ``enabled``, (A,) or bool), snapshot the current state and
    tracks into the agent's keyframe ring and reset its counters, which
    advance only where ``enabled``. Returns (db, kf_meta, selected (A,))."""
    a = fs.cov.shape[0]
    if not isinstance(enabled, torch.Tensor):
        enabled = torch.full((a,), bool(enabled), dtype=torch.bool, device=fs.cov.device)
    sel = should_select_keyframe(params, fs, slots, kf_meta.last_kf_pos,
                                 kf_meta.frames_since) & enabled
    db_new = db_mod.add_keyframe(db_dims, db, extract_payload_desc(params, fs, slots), words)
    db = tree.where(sel, db_new, db)
    core = rb.get_slot(fs.buffer, fs.anchor_buf_idx)
    kf_meta = KfMeta(
        last_kf_pos=torch.where(sel[:, None], core.p, kf_meta.last_kf_pos),
        frames_since=torch.where(sel, 0, kf_meta.frames_since + enabled.to(torch.int32))
        .to(torch.int32),
    )
    return db, kf_meta, sel


def maybe_add_keyframe_fn(params: VioParams, db_dims) -> graph.Compiled:
    """:func:`maybe_add_keyframe` compiled: one CUDA graph per call on the
    card, the database and :class:`KfMeta` the carry (``utils/graph.py``:
    the returned database, bookkeeping and selection are the program's
    buffers, valid until its next call). Each caller keeps its own program.
    ``(db, kf_meta, words, fs, slots, enabled (A,) bool) -> (db, kf_meta,
    selected (A,))``; with the recorder on a call is the host span
    ``keyframe``."""

    def step(db, kf_meta, words, fs, slots, enabled):
        return maybe_add_keyframe(params, db_dims, words, fs, slots, db, kf_meta, enabled=enabled)

    return graph.compiled(step, "keyframe", n_carry=2)


def process_matches_collab(params: VioParams, ccfg: CollabConfig, db_dims, words, fs, slots,
                           store, db, kf_meta: KfMeta, meas_time, meas):
    """One collaborative visual update: stored cross-agent matches are
    upgraded and consumed inside the update, then the keyframe step runs on
    the agents whose update applied. Returns (fs, slots, store, db,
    kf_meta, applied, kf_selected, n_collab), each per agent."""
    fs, (slots, store, n_collab), applied = visual_update_with_store(
        params, ccfg, fs, slots, store, meas_time, meas
    )
    db, kf_meta, sel = maybe_add_keyframe(params, db_dims, words, fs, slots, db, kf_meta,
                                          enabled=applied)
    return fs, slots, store, db, kf_meta, applied, sel, n_collab


def match_update_collab(params: VioParams, ccfg: CollabConfig, db_dims, fs, slots, store, db,
                        kf_meta: KfMeta, words, x, matches):
    """The ``VIO`` facade's collaborative update program:
    :func:`process_matches_collab` on the facade's packed host row ``x``
    (``vio.frame_measurement``). Returns (fs, slots, store, db, kf_meta,
    report (A, 4) (``vio.update_report``), n_collab)."""
    fs, slots, store, db, kf_meta, applied, sel, n_collab = process_matches_collab(
        params, ccfg, db_dims, words, fs, slots, store, db, kf_meta,
        *frame_measurement(params, x, matches))
    return fs, slots, store, db, kf_meta, update_report(fs, applied, sel), n_collab


def payload_nbytes(payload: AgentPayload) -> int:
    """Wire size in bytes of one agent's payload (static)."""
    leaves = (getattr(payload, f.name) for f in dataclasses.fields(payload))
    return sum(x[0].numel() * x.element_size() for x in leaves)


def vlad_nbytes(words: torch.Tensor) -> int:
    """Wire size of one VLAD query: W x 32 bytes."""
    return int(words.shape[0]) * 32


def query_vlad(words: torch.Tensor, slots) -> torch.Tensor:
    """Requester side: each agent's VLAD (A, W, 32) of its current SLAM and
    opportunistic track descriptors."""
    desc = torch.cat([slots.slam_desc, slots.opp_desc], dim=1)
    valid = torch.cat([slots.slam_desc_valid, slots.opp_desc_valid], dim=1)
    return compute_vlad(words, desc, valid)


def top_k_select(hits: torch.Tensor, scores: torch.Tensor, k: int):
    """Each requester's K best-scoring responders as gather indices (lower
    responder first among equal scores). hits/scores: (A requesters, P
    responders); k <= 0 keeps all P. Returns (sel (A, K), valid (A, K))."""
    a, p = hits.shape
    if k <= 0 or k >= p:
        return torch.arange(p, dtype=torch.int32, device=hits.device).expand(a, p), hits
    sc = torch.where(hits, scores, float("-inf"))
    order = topk_stable(sc, k)[1]
    return order.to(torch.int32), torch.gather(hits, 1, order)


def request_response_round(params: VioParams, ccfg: CollabConfig, words: torch.Tensor, fs, slots,
                           db, sampler=None):
    """One VLAD request-response exchange for A agents.

    Requests are answered in requester order (each answer marks the
    responder's keyframe served, which the next requester sees), batched
    over responders: responder b answers requester r with its best unserved
    keyframe above ``pr_score_thr`` (a self-request marks it served but is
    no hit). Each requester then fuses its hits (its top ``top_k_peers`` by
    score) in responder order with :func:`fuse_chain_desc`, each response
    its own responder's keyframe.

    Returns (fs, db, hits (A requesters, A responders), n_matches (A, K)).
    Raises when A exceeds the served bitmap (``DbDims.max_agents``), and on
    CUDA if TF32 matmuls are on."""
    linalg.require_fp32_matmul(fs.cov.device, "request_response_round")
    a = fs.cov.shape[0]
    if a > db.served.shape[-1]:
        raise ValueError(f"{a} agents exceed the served bitmap of {db.served.shape[-1]} "
                         "(raise DbDims.max_agents)")
    dev = fs.cov.device
    ids = torch.arange(a, device=dev)
    vlads = query_vlad(words, slots)  # (A, W, 32)
    idx_cols, hit_cols, score_cols = [], [], []
    for r in range(a):
        idx, found, score, db = db_mod.find_candidate_scored(
            db, r, vlads[r].expand_as(vlads), ccfg.pr_score_thr
        )
        idx_cols.append(idx)
        hit_cols.append(found & (ids != r))
        score_cols.append(score)
    kf_idx = torch.stack(idx_cols, 1)  # [responder, requester]
    hit_grid = torch.stack(hit_cols, 1)
    score_grid = torch.stack(score_cols, 1)

    sel, sel_valid = top_k_select(hit_grid.T, score_grid.T, ccfg.top_k_peers)
    kf_by_req = tree.map_leaves(lambda x: take(x, kf_idx), db.payload)
    fs, n_matches = fuse_chain_desc(params, ccfg, fs, slots, kf_by_req, sel, sel_valid,
                                    sampler=sampler)
    hits_kept = torch.zeros((a, a), dtype=torch.int32, device=dev).scatter_reduce(
        1, sel.long(), sel_valid.to(torch.int32), "amax") > 0
    timing.tally("round_hits", hits_kept)
    timing.tally("round_matches", n_matches)
    return fs, db, hits_kept, n_matches


# ---------------------------------------------------------------------------
# persistent match store
# ---------------------------------------------------------------------------


def receive_and_record(params: VioParams, ccfg: CollabConfig, fs, slots, store,
                       payload: AgentPayload, uav_id, payload_valid=True, recency=None,
                       sampler=None):
    """Receive one peer payload per agent: SLAM-SLAM matches CI-fuse at once
    (:func:`fuse_with_peer_desc`); own-OPP descriptor matches against the
    peer's collaborative and SLAM sets go into the match store (when
    ``ccfg.record_opp_matches``), consumed by later visual updates.
    ``uav_id``, ``payload_valid``: (A,) or scalars. Returns (fs, store,
    n_fused (A,), recency')."""
    a = fs.cov.shape[0]
    if not isinstance(payload_valid, torch.Tensor):
        payload_valid = torch.full((a,), bool(payload_valid), dtype=torch.bool,
                                   device=fs.cov.device)
    fs, n, recency1 = fuse_with_peer_desc(params, ccfg, fs, slots, payload, payload_valid,
                                          recency=recency, sampler=sampler)
    if ccfg.record_opp_matches:
        store = ms_mod.record(store, slots, payload, uav_id, ccfg.desc_ratio_thr,
                              ccfg.desc_abs_thr, store_when=payload_valid,
                              ransac_thr=ccfg.pr_ransac_thr, sampler=sampler)
    return fs, store, n, recency1


def receive_and_record_packed(params: VioParams, ccfg: CollabConfig, fs, slots, store,
                              payload: AgentPayload, x, recency=None, sampler=None):
    """The ``VIO`` facade's receive program: :func:`receive_and_record` with
    (sender id, payload valid) packed in one float64 row per agent, ``x``
    (A, 2). Returns (fs, slots, store, n_fused (A,), recency')."""
    fs, store, n, recency1 = receive_and_record(
        params, ccfg, fs, slots, store, payload, x[:, 0].to(torch.int32), x[:, 1] != 0,
        recency=recency, sampler=sampler)
    return fs, slots, store, n, recency1


def visual_update_with_store(params: VioParams, ccfg: CollabConfig, fs, slots, store,
                             meas_time, meas):
    """Visual update that also upgrades and consumes stored cross-agent
    matches (joint-MSCKF CI, SLAM-SLAM upgrades, matched-dead-track CI).
    Returns (fs, (slots, store, n_collab), applied)."""

    def update_fn(core, vision, cov, aux):
        core, vision, cov, slots1, store1, n_collab = pipeline.visual_update(
            params.cfg, core, vision, cov, aux[0], meas, store=aux[1], collab_cfg=ccfg,
        )
        return core, vision, cov, (slots1, store1, n_collab)

    return ekf_mod.process_update_aux_impl(
        params.ekf_params, fs, meas_time, update_fn, (slots, store, torch.zeros_like(fs.head)),
    )
