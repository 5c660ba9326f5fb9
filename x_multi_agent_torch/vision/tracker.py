"""Detect-track front end (port of ``x_multi_agent_tpu.vision.tracker``).

Per frame, for a batch of agents: build pyramids -> pyramidal LK on the live
features (kernel K2 on the card) -> fundamental-matrix RANSAC -> re-detect
FAST features (kernel K1 on the card) when an agent drops below n_feat_min,
suppressing neighbourhoods of tracked features -> emit matches. Features
live in fixed slots with stable ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from ..device import resolve
from ..ops.ransac import keyed_sample_indices, ransac_inliers
from ..place_recognition import descriptors
from ..utils import graph
from ..utils.tree import scatter_dump, take
from ..vio.track_manager import Matches, stable_partition
from . import camera as cam_mod
from . import fast, lk
from .image import build_pyramid


class TrackerParams(NamedTuple):
    budget: int = 200  # feature slots == match budget
    fast_threshold: float = 9.0
    non_max_supp: bool = True
    block_half_length: int = 20  # suppression neighbourhood around tracks
    margin: int = 20  # detection border margin
    n_feat_min: int = 80  # re-detect below this count
    n_tiles_h: int = 4
    n_tiles_w: int = 4
    max_feat_per_tile: int = 40
    pyramid_depth: int = 1  # levels detected on (level 0 = base image)
    win_half: int = 10  # LK window half-size
    lk_iters: int = 10
    lk_max_level: int = 2
    min_eig_thr: float = 1e-4
    ransac_threshold_px: float = 0.3
    ransac_hypotheses: int = 96
    compute_descriptors: bool = False  # steered-BRIEF descriptors of tracked features


@dataclass(frozen=True)
class TrackerState:
    pts: torch.Tensor  # (A, F, 2) pixel coords (distorted) in the last frame
    ids: torch.Tensor  # (A, F) int32, -1 = free slot
    scores: torch.Tensor  # (A, F) FAST score at detection
    levels: torch.Tensor  # (A, F) int32 pyramid level at detection
    next_id: torch.Tensor  # (A,) int32
    prev_img: torch.Tensor  # (A, H, W) last frame
    has_prev: torch.Tensor  # (A,) bool

    @staticmethod
    def zero(params: TrackerParams, a: int, h: int, w: int, dtype=torch.float32,
             device=None) -> "TrackerState":
        f = params.budget
        device = resolve(device)
        return TrackerState(
            pts=torch.zeros((a, f, 2), dtype=dtype, device=device),
            ids=torch.full((a, f), -1, dtype=torch.int32, device=device),
            scores=torch.zeros((a, f), dtype=dtype, device=device),
            levels=torch.zeros((a, f), dtype=torch.int32, device=device),
            next_id=torch.zeros((a,), dtype=torch.int32, device=device),
            prev_img=torch.zeros((a, h, w), dtype=dtype, device=device),
            has_prev=torch.zeros((a,), dtype=torch.bool, device=device),
        )


def _detect_new_batch(params: TrackerParams, pyramid, existing_pts, existing_valid):
    """FAST detection on every detected pyramid level (candidates scaled by
    2^level to base resolution) + suppression, batched over agents.
    Returns (xy (A,C,2), score (A,C), level (A,C), valid (A,C))."""
    xys, scores, levels, valids = [], [], [], []
    n_levels = min(params.pyramid_depth, len(pyramid))
    for l in range(n_levels):
        img_l = pyramid[l]
        lh = (img_l.shape[1] // params.n_tiles_h) * params.n_tiles_h
        lw = (img_l.shape[2] // params.n_tiles_w) * params.n_tiles_w
        xy_l, score_l, valid_l = fast.detect_batch(
            img_l[:, :lh, :lw].contiguous(), params.fast_threshold, params.n_tiles_h,
            params.n_tiles_w, params.max_feat_per_tile, params.non_max_supp,
        )
        xys.append(xy_l * (2.0**l))
        scores.append(score_l)
        levels.append(torch.full(score_l.shape, l, dtype=torch.int32, device=score_l.device))
        valids.append(valid_l)
    h, w = pyramid[0].shape[1:]
    return _suppress(
        params, h, w, torch.cat(xys, 1), torch.cat(scores, 1), torch.cat(levels, 1),
        torch.cat(valids, 1), existing_pts, existing_valid,
    )


def _suppress(params: TrackerParams, h: int, w: int, xy, score, level, valid,
              existing_pts, existing_valid):
    """Candidate filtering: image margin, live-feature neighbourhood
    suppression, cross-level dedup (a coarser candidate near a surviving
    finer one that scores at least as high is dropped)."""
    m = params.margin
    b = params.block_half_length
    inb = (xy[..., 0] >= m) & (xy[..., 0] < w - m) & (xy[..., 1] >= m) & (xy[..., 1] < h - m)
    d = torch.abs(xy[:, :, None, :] - existing_pts[:, None, :, :])  # (A, C, F, 2)
    near = (d[..., 0] <= b) & (d[..., 1] <= b)
    near_any = torch.any(near & existing_valid[:, None, :], dim=2)
    keep = valid & inb & ~near_any
    cross = (
        (torch.abs(xy[:, :, None, 0] - xy[:, None, :, 0]) <= b)
        & (torch.abs(xy[:, :, None, 1] - xy[:, None, :, 1]) <= b)
        & (level[:, :, None] > level[:, None, :])
        & keep[:, None, :]
        & (score[:, None, :] >= score[:, :, None])
    )
    return xy, score, level, keep & ~torch.any(cross, dim=2)


def _track_core(params, cam, state: TrackerState, imgs, pyr_prev, pyr_cur, ransac_idx,
                seed: int):
    """LK + RANSAC + match construction (everything except detection).
    Returns (matches, tracked, cur_pts)."""
    a, f = state.ids.shape
    dtype = imgs.dtype
    live = state.ids >= 0
    cur_pts, ok = lk.track(
        pyr_prev, pyr_cur, state.pts, live & state.has_prev[:, None],
        half_win=params.win_half, n_iters=params.lk_iters, min_eig_thr=params.min_eig_thr,
    )
    if ransac_idx is None:
        # keyed on the agent's id counter, as the reference folds next_id
        # into its key: the hypotheses vary per frame and follow the state
        ransac_idx = keyed_sample_indices(ok, params.ransac_hypotheses, 8, seed, state.next_id)
    inliers = ransac_inliers(state.pts, cur_pts, ok, ransac_idx, params.ransac_threshold_px)
    tracked = ok & inliers

    prev_n = cam_mod.normalize(cam, cam_mod.undistort(cam, state.pts))
    cur_n = cam_mod.normalize(cam, cam_mod.undistort(cam, cur_pts))
    if params.compute_descriptors:
        desc, desc_ok = descriptors.compute(imgs, cur_pts, tracked)
    else:
        desc = torch.zeros((a, f, 32), dtype=torch.uint8, device=imgs.device)
        desc_ok = torch.zeros((a, f), dtype=torch.bool, device=imgs.device)
    h_img, w_img = imgs.shape[1:]
    tile_r = torch.clamp((cur_pts[..., 1] * params.n_tiles_h / h_img).to(torch.int32),
                         0, params.n_tiles_h - 1)
    tile_c = torch.clamp((cur_pts[..., 0] * params.n_tiles_w / w_img).to(torch.int32),
                         0, params.n_tiles_w - 1)
    t2 = tracked[..., None]
    matches = Matches(
        track_id=torch.where(tracked, state.ids, -1),
        prev_pt=torch.where(t2, prev_n, 0.0).to(dtype),
        cur_pt=torch.where(t2, cur_n, 0.0).to(dtype),
        valid=tracked,
        desc=desc,
        desc_valid=desc_ok & tracked,
        tile=torch.where(tracked, tile_r * params.n_tiles_w + tile_c, -1).to(torch.int32),
        level=torch.where(tracked, state.levels, 0).to(torch.int32),
    )
    return matches, tracked, cur_pts


def _integrate(params, state: TrackerState, imgs, tracked, cur_pts, cand_xy, cand_score,
               cand_level, cand_valid) -> TrackerState:
    """Slot update: keep tracked features, fill free slots with the best
    detection candidates (score-sorted append, stable)."""
    f = params.budget
    dtype = imgs.dtype
    pts1 = torch.where(tracked[..., None], cur_pts, 0.0)
    ids1 = torch.where(tracked, state.ids, -1)
    scores1 = torch.where(tracked, state.scores, 0.0)
    levels1 = torch.where(tracked, state.levels, 0)

    key = torch.where(cand_valid, cand_score, float("-inf"))
    order = torch.argsort(-key, dim=1, stable=True)
    cand_xy, cand_score = take(cand_xy, order), take(cand_score, order)
    cand_level, cand_valid = take(cand_level, order), take(cand_valid, order)

    free = ~tracked
    free_idx = stable_partition(free)  # free slots first
    n_free = torch.sum(free, dim=1, keepdim=True)
    c = cand_xy.shape[1]
    rank = torch.arange(c, device=imgs.device)
    can_place = cand_valid & (rank < n_free)
    tgt = torch.where(can_place, take(free_idx, torch.clamp(rank, 0, f - 1).expand_as(can_place)).long(), f)
    new_ids = state.next_id[:, None] + torch.cumsum(can_place.to(torch.int32), 1) - 1
    return TrackerState(
        pts=scatter_dump(pts1, tgt, cand_xy.to(dtype)),
        ids=scatter_dump(ids1, tgt, new_ids.to(torch.int32)),
        scores=scatter_dump(scores1, tgt, cand_score.to(dtype)),
        levels=scatter_dump(levels1, tgt, cand_level),
        next_id=(state.next_id + torch.sum(can_place, 1)).to(torch.int32),
        prev_img=imgs,
        has_prev=torch.ones_like(state.has_prev),
    )


def _track_segment(params: TrackerParams, cam, state: TrackerState, imgs, ransac_idx,
                   seed: int):
    """Pyramids, LK (K2) and RANSAC: (matches, tracked, cur_pts, the current
    pyramid, need_detect (A,), need_detect.any())."""
    depth = params.lk_max_level
    pyr_prev = build_pyramid(state.prev_img, depth)
    pyr_cur = build_pyramid(imgs, depth)
    matches, tracked, cur_pts = _track_core(
        params, cam, state, imgs, pyr_prev, pyr_cur, ransac_idx, seed
    )
    need_detect = torch.sum(tracked, dim=1) < params.n_feat_min  # (A,)
    return matches, tracked, cur_pts, tuple(pyr_cur), need_detect, need_detect.any()


def _detect_segment(params: TrackerParams, state: TrackerState, imgs, tracked, cur_pts,
                    pyr_cur, need_detect) -> TrackerState:
    """The detection branch: FAST (K1), tile top-k and suppression, then the
    slot update (only agents below the minimum append candidates)."""
    pts1 = torch.where(tracked[..., None], cur_pts, 0.0)
    cand_xy, cand_score, cand_level, cand_valid = _detect_new_batch(
        params, pyr_cur, pts1, tracked
    )
    return _integrate(
        params, state, imgs, tracked, cur_pts, cand_xy, cand_score, cand_level,
        cand_valid & need_detect[:, None],
    )


def _keep_segment(state: TrackerState, imgs, tracked, cur_pts) -> TrackerState:
    """The branch without detection: tracked features stay in their slots."""
    return TrackerState(
        pts=torch.where(tracked[..., None], cur_pts, 0.0).to(imgs.dtype),
        ids=torch.where(tracked, state.ids, -1),
        scores=torch.where(tracked, state.scores, 0.0),
        levels=torch.where(tracked, state.levels, 0),
        next_id=state.next_id,
        prev_img=imgs,
        has_prev=torch.ones_like(state.has_prev),
    )


def track_frame_batch(
    params: TrackerParams,
    cam: cam_mod.Camera,
    state: TrackerState,
    imgs: torch.Tensor,  # (A, H, W)
    seed: int = 0,
    ransac_idx: Optional[torch.Tensor] = None,
) -> Tuple[TrackerState, Matches]:
    """One tracker frame for a batch of agents.

    RANSAC hypotheses come from ``ransac_idx`` (A, S, 8) when given, else
    they are drawn over each agent's LK-valid matches, keyed on (``seed``,
    the agent's ``next_id``) (``ops.ransac.keyed_sample_indices``).

    Detection runs only when at least one agent has fewer than
    ``n_feat_min`` live tracks (the reference's batch-level ``lax.cond``);
    the test is a Python branch here, so it costs one device-to-host sync
    per frame. Per agent, only agents below the minimum append candidates.
    """
    matches, tracked, cur_pts, pyr_cur, need_detect, need_any = _track_segment(
        params, cam, state, imgs, ransac_idx, seed
    )
    if bool(need_any):
        new_state = _detect_segment(params, state, imgs, tracked, cur_pts, pyr_cur, need_detect)
    else:
        new_state = _keep_segment(state, imgs, tracked, cur_pts)
    return new_state, matches


class TrackerProgram(graph.Programs):
    """:func:`track_frame_batch` as compiled programs (``utils/graph.py``),
    the counterpart of the reference's ``track_frame_batch_jit``: per
    capture key three CUDA graphs around the detection gate, (a) pyramids,
    LK (K2) and RANSAC, (b) the detection branch (K1, tile top-k, the slot
    update) and (c) the keep branch. A call replays (a), reads the gate (one
    host read per frame, as :func:`track_frame_batch`), then replays (b) or
    (c), each captured on its first use. The tracker state is the carry: a
    call returns its buffers and (a)'s matches, both valid until the next
    call. ``(state, imgs, seed=0, ransac_idx=None) -> (state, matches)``."""

    def __init__(self, params: TrackerParams, cam: cam_mod.Camera, name: str = "tracker"):
        super().__init__(name)
        self.params, self.cam = params, cam

    def __call__(self, state: TrackerState, imgs: torch.Tensor, seed: int = 0,
                 ransac_idx: Optional[torch.Tensor] = None) -> Tuple[TrackerState, Matches]:
        dev, bufs, prog = self.get((state, imgs, ransac_idx),
                                   lambda b, label: self._program(b, seed, label), seed)
        out = prog["a"](dev)
        prog["a_out"] = out
        prog["b" if bool(out[-1]) else "c"](dev)
        return bufs[0], out[0]

    def _program(self, bufs, seed: int, label: str) -> dict:
        p, g = self.params, self.graphs
        state, imgs, ridx = bufs
        prog = {}

        def detect():
            _, tracked, cur_pts, pyr, need, _ = prog["a_out"]
            graph.write_carry(state, _detect_segment(p, state, imgs, tracked, cur_pts, pyr, need),
                              g.name)
            return ()

        def keep():
            _, tracked, cur_pts = prog["a_out"][:3]
            graph.write_carry(state, _keep_segment(state, imgs, tracked, cur_pts), g.name)
            return ()

        prog["a"] = g.graph(f"{label}:track",
                            lambda: _track_segment(p, self.cam, state, imgs, ridx, seed))
        prog["b"] = g.graph(f"{label}:detect", detect)
        prog["c"] = g.graph(f"{label}:keep", keep)
        return prog


_JIT_PROGRAM = {}  # the last (params, cam) of track_frame_batch_jit and its program


def track_frame_batch_jit(
    params: TrackerParams,
    cam: cam_mod.Camera,
    state: TrackerState,
    imgs: torch.Tensor,
    seed: int = 0,
    ransac_idx: Optional[torch.Tensor] = None,
) -> Tuple[TrackerState, Matches]:
    """:func:`track_frame_batch` compiled (the reference's
    ``track_frame_batch_jit``): a :class:`TrackerProgram` for the last
    (params, cam) it was called with. A call with another pair drops that
    program and its graphs' memory pool; a caller that alternates keeps a
    :class:`TrackerProgram` of its own for each. The returned state and
    matches stay valid until the next call."""
    prog = _JIT_PROGRAM.get((params, cam))
    if prog is None:
        _JIT_PROGRAM.clear()
        prog = _JIT_PROGRAM[(params, cam)] = TrackerProgram(params, cam, "track_frame_batch_jit")
    return prog(state, imgs, seed, ransac_idx)


def track_frame(
    params: TrackerParams,
    cam: cam_mod.Camera,
    state: TrackerState,
    img: torch.Tensor,  # (H, W)
    seed: int = 0,
    ransac_idx: Optional[torch.Tensor] = None,
) -> Tuple[TrackerState, Matches]:
    """One tracker frame for a single agent: :func:`track_frame_batch` at
    A = 1 (``state``, the matches and ``ransac_idx`` keep their agent axis
    of 1)."""
    return track_frame_batch(params, cam, state, img[None], seed, ransac_idx)
