"""Batched fundamental-matrix RANSAC for epipolar outlier rejection (port
of ``x_multi_agent_tpu.ops.ransac``).

Hypotheses are a fixed batch of normalized 8-point solves (Cholesky inverse
iteration on A^T A), inlier voting is one (S x N) Sampson-distance matrix.

The sample indices are an INPUT here. The reference draws them with
``jax.random.categorical`` under a key folded from state (a seed, a time, an
agent's counter), whose bits torch cannot reproduce; the port draws them
with :func:`keyed_sample_indices`, a counter-based draw keyed the same way,
so a draw depends on state alone and a resumed run repeats it. Parity tests
pass the reference's own draws instead.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from . import linalg
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
        x = linalg.cholesky_solve(x, c)
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


_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9


def _mix(x):
    """A 32-bit integer hash of ``x``: a Python int, hashed on the host, or
    an int64 tensor holding 32 bits. Both multipliers are below 2^31, so no
    product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _key_bits(key, a: int):
    """One key as 32 bits: a Python int stays one; a tensor becomes (A,)
    int64, a float key by its float32 bits, as the reference folds
    ``peer.time``."""
    if not isinstance(key, torch.Tensor):
        return int(key) & _M32
    if key.is_floating_point():
        key = key.to(torch.float32).view(torch.int32)
    return key.to(torch.int64).expand(a) & _M32


@functools.lru_cache(maxsize=None)
def _counter_bits(n: int, device: torch.device) -> torch.Tensor:
    """The hashed counters 1..n, (n,) int64, built once per (n, device)."""
    return _mix(torch.arange(1, n + 1, dtype=torch.int64, device=device))


def keyed_sample_indices(mask: torch.Tensor, n_hypotheses: int, sample_size: int, seed: int,
                         *keys) -> torch.Tensor:
    """(A, S, sample_size) sample indices per row of ``mask`` (A, N), with
    replacement, uniform over the row's valid entries (over all entries
    when none is valid, as the reference's floored log-probabilities give).

    A counter-based draw: the row's key h = mix(seed + c) folded with each
    key k as h = mix((h + c) ^ k); entry (a, s, j) hashes h with the counter
    s * sample_size + j into 24 bits u and takes the valid entry of rank
    floor(u * n_valid / 2^24) by inverse CDF. Each key is an (A,) integer or
    float tensor or a Python int; the seed and the Python-int keys before
    the first tensor key are folded on the host. A row's indices depend on
    its own mask and keys only, never on A or the other rows, and are the
    same bits on every device. Nothing is read back to the host."""
    a, n = mask.shape
    h = _mix((seed + _GOLD) & _M32)
    for key in keys:
        h = _mix(((h + _GOLD) & _M32) ^ _key_bits(key, a))
    h = (h + _GOLD) & _M32
    ctr = _counter_bits(n_hypotheses * sample_size, mask.device)
    u = _mix(h[:, None] ^ ctr if isinstance(h, torch.Tensor) else ctr ^ h) >> 8  # (A | 1, S*s)
    w = mask | ~mask.any(-1, keepdim=True)  # no valid entry: all
    cdf = torch.cumsum(w, -1)
    rank = (u * cdf[:, -1:]) >> 24
    idx = torch.searchsorted(cdf, rank, right=True)
    return idx.reshape(a, n_hypotheses, sample_size)


class KeyedSampler(NamedTuple):
    """A RANSAC sample-index source, ``sampler(mask (A, N), *keys)`` ->
    (A, n_hypotheses, sample_size) by :func:`keyed_sample_indices` on
    (``seed``, keys). The collaboration's gates call it with (salt, t, k):
    the reference keys that draw on ``PRNGKey(salt)`` folded with the
    float32 bits of ``t`` (A,) and then with ``k`` (A,). The facade's
    photometric calibration calls it with (frame, history row). Parity tests
    pass one that repeats the reference's draw."""

    seed: int = 0
    n_hypotheses: int = 200
    sample_size: int = 8

    def __call__(self, mask, *keys):
        return keyed_sample_indices(mask, self.n_hypotheses, self.sample_size, self.seed, *keys)


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
