"""Batched fundamental-matrix RANSAC for epipolar outlier rejection (port
of ``x_multi_agent_tpu.ops.ransac``).

Hypotheses are a fixed batch of normalized 8-point solves (Cholesky inverse
iteration on A^T A), inlier voting is one (S x N) Sampson-distance matrix.

The sample indices are an INPUT here: the reference draws them with
``jax.random.categorical``, whose bits torch cannot reproduce, so callers
draw them (:func:`draw_sample_indices`, from a ``torch.Generator``) or pass
the reference's own draws in parity tests.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..utils.const import constant
from ..utils.tree import take


def _normalize_pts(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization (centroid 0, RMS distance sqrt(2)) of (A, N, 2)
    points over the mask. Returns (normalized points, T (A, 3, 3))."""
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w, -1), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=-2) / n[..., None]
    d = torch.sqrt(torch.sum((pts - mean[..., None, :]) ** 2, dim=-1))
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(d * w, -1) / n, min=1e-9)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    t = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], -1),
        torch.stack([zero, scale, -scale * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=-2)
    return (pts - mean[..., None, :]) * scale[..., None, None], t


_START = (0.21, -0.43, 0.61, -0.79, 0.97, 0.33, -0.51, 0.69, 0.87)


def _eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """F from 8 normalized correspondences, (..., 8, 2) x2 -> (..., 3, 3):
    the null vector of A^T A by 4 steps of regularized Cholesky inverse
    iteration from a structureless start vector (rank-2 enforcement is left
    to the winner). A failed factorization yields NaN, as in the reference."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], -1)
    m = a.transpose(-1, -2) @ a
    eye = torch.eye(9, dtype=a.dtype, device=a.device)
    tr = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    m = m + (1e-10 * tr + 1e-30)[..., None, None] * eye
    c, info = torch.linalg.cholesky_ex(m)
    c = torch.where((info == 0)[..., None, None], c, float("nan"))
    x = constant(_START, a.dtype, a.device).expand(m.shape[:-1])[..., None]
    for _ in range(4):
        x = torch.cholesky_solve(x, c)
        x = x / torch.clamp(torch.linalg.norm(x, dim=-2, keepdim=True), min=1e-30)
    return x[..., 0].reshape(m.shape[:-2] + (3, 3))


def sampson_dist(f: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Sampson distance of correspondences (..., N, 2) under F (..., 3, 3)."""
    ones = torch.ones_like(p1[..., :1])
    x1 = torch.cat([p1, ones], dim=-1)
    x2 = torch.cat([p2, ones], dim=-1)
    fx1 = x1 @ f.transpose(-1, -2)  # F @ x1
    ftx2 = x2 @ f  # F^T @ x2
    num = torch.sum(x2 * fx1, dim=-1) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def draw_sample_indices(mask: torch.Tensor, n_hypotheses: int, generator: torch.Generator):
    """(A, S, 8) sample indices per agent, with replacement, uniform over
    the valid entries of ``mask`` (A, N) (uniform over all when none is
    valid, as the reference's floored log-probabilities give)."""
    a, n = mask.shape
    w = mask.to(torch.float32)
    w = torch.where(w.sum(-1, keepdim=True) > 0, w, torch.ones_like(w))
    idx = torch.multinomial(w, n_hypotheses * 8, replacement=True, generator=generator)
    return idx.reshape(a, n_hypotheses, 8)


def generator_sampler(generator: torch.Generator, n_hypotheses: int = 200):
    """The sample-index source of the collaboration's RANSAC gates.

    Those gates call ``sampler(mask, seed, t, k)`` -> (A, S, 8), where the
    reference would key its draw on ``PRNGKey(seed)`` folded with the float32
    bits of ``t`` (A,) and then with ``k`` (A,). This sampler draws from
    ``generator`` and ignores the key; parity tests pass one that repeats
    the reference's draw."""

    def draw(mask, seed, t, k):
        return draw_sample_indices(mask, n_hypotheses, generator)

    return draw


def _vote(pts1, pts2, mask, idx, threshold: float):
    p1n, t1 = _normalize_pts(pts1, mask)
    p2n, t2 = _normalize_pts(pts2, mask)
    f_all = _eight_point(take(p1n, idx), take(p2n, idx))  # (A, S, 3, 3)
    thr_n = threshold * t1[:, 0, 0]  # threshold is in pixels
    d = sampson_dist(f_all, p1n[:, None], p2n[:, None])  # (A, S, N)
    good = d < (thr_n * thr_n)[:, None, None]
    votes = torch.sum(good & mask[:, None, :], dim=-1)
    best = torch.argmax(votes, dim=-1)
    ar = torch.arange(best.shape[0], device=best.device)
    inliers = good[ar, best] & mask
    enough = torch.sum(mask, -1) >= 8
    inliers = torch.where(enough[:, None], inliers, mask)
    return inliers, f_all[ar, best], t1, t2


def ransac_inliers(pts1, pts2, mask, idx, threshold: float) -> torch.Tensor:
    """Inlier mask (A, N) of the best hypothesis; degenerate inputs (fewer
    than 8 valid matches) return the input mask."""
    return _vote(pts1, pts2, mask, idx, threshold)[0]


def fundamental_ransac(
    pts1: torch.Tensor,  # (A, N, 2)
    pts2: torch.Tensor,  # (A, N, 2)
    mask: torch.Tensor,  # (A, N)
    idx: torch.Tensor,  # (A, S, 8) sample indices
    threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (inlier_mask (A, N), best F (A, 3, 3), rank 2)."""
    inliers, f_best_n, t1, t2 = _vote(pts1, pts2, mask, idx, threshold)
    u, s, vt = torch.linalg.svd(f_best_n)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    f_best_n = u @ torch.diag_embed(s) @ vt
    return inliers, t2.transpose(-1, -2) @ f_best_n @ t1
