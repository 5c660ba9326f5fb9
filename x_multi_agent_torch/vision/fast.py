"""FAST-9/16 corner detection + non-max suppression + tiled top-K (port of
``x_multi_agent_tpu.vision.fast``).

The score map comes from :func:`fast_score_nms`: on a CUDA tensor it launches
the hand-written kernel K1 (``csrc/fast.cu``, replacing the Pallas kernels
``vision/pallas_fast.py:fast_score_nms_batch`` and ``fast_score_nms``); on a
CPU tensor it runs the plain version beside it, :func:`fast_score` +
:func:`nms3`. The two are held equal exactly (atol 0): the kernel uses only
subtract, min, max and compare.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import native
from ..utils.tree import topk_stable

# Bresenham circle radius 3, clockwise from 12 o'clock: (dy, dx)
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9

K1 = native.Kernel("fast_score_nms")


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9 corner score (0 where not a corner) of (..., H, W)
    images. Border pixels (3 px) score 0."""
    h, w = img.shape[-2:]
    if not img.is_floating_point():
        img = img.float()
    diffs = torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(-2, -1)) - img for (dy, dx) in CIRCLE]
    )  # (16, ..., H, W): circle pixel minus centre

    def arc_score(d):
        best = None
        for i in range(16):
            m = d[i]
            for j in range(1, ARC):
                m = torch.minimum(m, d[(i + j) % 16])
            best = m if best is None else torch.maximum(best, m)
        return best

    score = torch.maximum(arc_score(diffs), arc_score(-diffs))
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(interior, score, torch.zeros_like(score))


def compass_candidates(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(..., H, W) bool: interior pixels where two cyclically adjacent
    compass taps (circle taps 0, 4, 8, 12) both differ from the centre by
    more than ``threshold`` in one polarity. Every 9-arc holds such a pair,
    so every other pixel's :func:`fast_score` is 0: K1 scores only these."""
    h, w = img.shape[-2:]
    d = [torch.roll(img, (-CIRCLE[k][0], -CIRCLE[k][1]), dims=(-2, -1)) - img
         for k in (0, 4, 8, 12)]
    cand = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    for k in range(4):
        a, b = d[k], d[(k + 1) % 4]
        cand = cand | ((a > threshold) & (b > threshold)) | ((-a > threshold) & (-b > threshold))
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    return cand & (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression of (..., H, W) score maps: keep a pixel that
    is >= every in-image neighbour (out-of-image neighbours are -inf)."""
    h, w = score.shape[-2:]
    pad = torch.full(
        score.shape[:-2] + (h + 2, w + 2), float("-inf"),
        dtype=score.dtype, device=score.device,
    )
    pad[..., 1 : h + 1, 1 : w + 1] = score
    neigh = None
    for dy in range(3):
        for dx in range(3):
            v = pad[..., dy : dy + h, dx : dx + w]
            neigh = v if neigh is None else torch.maximum(neigh, v)
    return torch.where(score >= neigh, score, torch.zeros_like(score))


def fast_score_nms(imgs: torch.Tensor, threshold: float, nms: bool = True) -> torch.Tensor:
    """FAST score + threshold + border zeroing (+ 3x3 NMS) of (A, H, W)
    float32 images -> (A, H, W) scores.

    CPU tensor: the plain version. CUDA tensor: kernel K1, or raise."""
    if not imgs.is_cuda:
        score = fast_score(imgs, threshold)
        return nms3(score) if nms else score
    native.check_cuda_tensor("imgs", imgs, torch.float32)
    if imgs.dim() != 3:
        raise ValueError(f"imgs: expected (A, H, W), got {tuple(imgs.shape)}")
    a, h, w = imgs.shape
    out = torch.empty_like(imgs)
    K1.launch(
        "xmat_fast_score_nms", imgs.data_ptr(), out.data_ptr(),
        a, h, w, int(bool(nms)), float(threshold),
    )
    return out


def _tile_topk(
    score: torch.Tensor,  # (A, H, W)
    n_tiles_h: int,
    n_tiles_w: int,
    cap_per_tile: int,
    dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile top-K of (A, H, W) score maps; ties keep the lower index
    first, as ``lax.top_k`` does. Returns (xy (A,T*cap,2), score, valid)."""
    a, h, w = score.shape
    th, tw = h // n_tiles_h, w // n_tiles_w
    tiles = score.reshape(a, n_tiles_h, th, n_tiles_w, tw).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(a, n_tiles_h * n_tiles_w, th * tw)
    top, idx = topk_stable(tiles, cap_per_tile)  # (A, T, cap)
    dev = score.device
    ty = torch.arange(n_tiles_h, device=dev).repeat_interleave(n_tiles_w)[:, None]
    tx = torch.arange(n_tiles_w, device=dev).repeat(n_tiles_h)[:, None]
    py = ty * th + torch.div(idx, tw, rounding_mode="floor")
    px = tx * tw + idx % tw
    xy = torch.stack([px, py], dim=-1).reshape(a, -1, 2).to(dtype)
    scores = top.reshape(a, -1)
    return xy, scores, scores > 0


def detect_batch(
    imgs: torch.Tensor,  # (A, H, W)
    threshold: float,
    n_tiles_h: int,
    n_tiles_w: int,
    cap_per_tile: int,
    non_max_supp: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched tiled FAST detection. Returns (xy (A,K,2) float pixel coords,
    score (A,K), valid (A,K)), K = n_tiles_h * n_tiles_w * cap_per_tile,
    sorted by score within tiles. Image dims must divide by the tile counts."""
    score = fast_score_nms(imgs.contiguous(), threshold, nms=non_max_supp)
    return _tile_topk(score, n_tiles_h, n_tiles_w, cap_per_tile, imgs.dtype)


def detect(img, threshold, n_tiles_h, n_tiles_w, cap_per_tile, non_max_supp=True):
    """Single-image :func:`detect_batch` (A = 1)."""
    xy, s, v = detect_batch(
        img[None], threshold, n_tiles_h, n_tiles_w, cap_per_tile, non_max_supp
    )
    return xy[0], s[0], v[0]
