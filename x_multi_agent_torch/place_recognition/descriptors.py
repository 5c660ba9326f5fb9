"""Binary feature descriptors, steered BRIEF (port of
``x_multi_agent_tpu.place_recognition.descriptors``).

Orientation from the intensity centroid of a radius-15 disc (ORB's Rosin
moments), then 256 comparisons of smoothed-image samples at a fixed
Gaussian test-pair pattern rotated by that orientation, packed LSB-first
into 32 bytes. The pattern comes from the reference's seed, so descriptors
agree bit for bit with the reference's (not with OpenCV's ORB).

Every function takes a leading agent axis A. Bytes are packed with shifts
and an int32 sum (the reference's uint8 matmul has no CUDA counterpart);
popcounts are a 256-entry table built once per device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.const import constant
from ..vision.image import _sep_blur5, bilinear_sample

N_BITS = 256
PATCH_R = 15


def _pattern() -> np.ndarray:
    """(256, 2, 2) test-pair coordinates, Gaussian like the BRIEF paper."""
    rng = np.random.default_rng(1234)
    pts = rng.normal(0.0, PATCH_R / 2.5, size=(N_BITS, 2, 2))
    return np.clip(pts, -PATCH_R + 1, PATCH_R - 1)


_PATTERN = tuple(_pattern().reshape(-1).tolist())
# intensity-centroid sampling disc, (dy, dx) rows
_DISC = tuple(
    float(v)
    for dy in range(-PATCH_R, PATCH_R + 1)
    for dx in range(-PATCH_R, PATCH_R + 1)
    if dx * dx + dy * dy <= PATCH_R * PATCH_R
    for v in (dy, dx)
)
_POPCOUNT = tuple(bin(i).count("1") for i in range(256))


def popcount_table(device) -> torch.Tensor:
    """(256,) int32 bit counts of every byte value."""
    return constant(_POPCOUNT, torch.int32, device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8k) 0/1 -> (..., k) uint8, LSB first."""
    b = bits.reshape(bits.shape[:-1] + (-1, 8)).to(torch.int32)
    shifts = constant(tuple(range(8)), torch.int32, bits.device)
    return torch.sum(b << shifts, dim=-1).to(torch.uint8)


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., k) uint8 -> (..., 8k) bool, LSB first."""
    shifts = constant(tuple(range(8)), torch.int32, x.device)
    bits = (x.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(x.shape[:-1] + (-1,)).bool()


def _samples(imgs: torch.Tensor, pts: torch.Tensor):
    """Smoothed-image samples of both test-pair ends: (va, vb) (A, K, 256)."""
    dtype, dev = imgs.dtype, imgs.device
    smooth = _sep_blur5(imgs)
    disc = constant(_DISC, dtype, dev).reshape(-1, 2)  # (P, 2) as (dy, dx)
    pattern = constant(_PATTERN, dtype, dev).reshape(N_BITS, 2, 2)
    a, k = pts.shape[:2]
    # orientation from the intensity centroid (ORB)
    grid = pts[:, :, None, :] + disc.flip(-1)  # (A, K, P, 2) in (x, y)
    vals = bilinear_sample(smooth, grid.reshape(a, -1, 2)).reshape(grid.shape[:-1])
    m10 = torch.sum(vals * disc[:, 1], dim=-1)
    m01 = torch.sum(vals * disc[:, 0], dim=-1)
    theta = torch.atan2(m01, m10)
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)  # (A, K, 2, 2)
    rot_t = rot.transpose(-1, -2)[:, :, None]  # (A, K, 1, 2, 2)
    pa = pts[:, :, None, :] + (pattern[:, 0, None, :] @ rot_t)[..., 0, :]  # (A, K, 256, 2)
    pb = pts[:, :, None, :] + (pattern[:, 1, None, :] @ rot_t)[..., 0, :]
    va = bilinear_sample(smooth, pa.reshape(a, -1, 2)).reshape(a, k, N_BITS)
    vb = bilinear_sample(smooth, pb.reshape(a, -1, 2)).reshape(a, k, N_BITS)
    return va, vb


def compute(imgs: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor):
    """Descriptors of A agents' keypoints.

    imgs (A, H, W) float; pts (A, K, 2) pixel coordinates (x, y); valid
    (A, K). Returns (desc (A, K, 32) uint8, ok (A, K)): ok also requires the
    whole patch inside the image."""
    h, w = imgs.shape[-2:]
    va, vb = _samples(imgs, pts)
    desc = pack_bits(va < vb)
    x, y = pts[..., 0], pts[..., 1]
    inb = (
        (x >= PATCH_R + 2) & (x < w - PATCH_R - 2)
        & (y >= PATCH_R + 2) & (y < h - PATCH_R - 2)
    )
    return desc, inb & valid


def bit_margin(imgs: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """|va - vb| (A, K, 256) of each bit's comparison: a bit whose margin is
    within rounding of zero may flip between two correct implementations."""
    va, vb = _samples(imgs, pts)
    return torch.abs(va - vb)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., Na, 32) x (..., Nb, 32) uint8 -> (..., Na, Nb) int32 Hamming
    distances (XOR + popcount)."""
    x = torch.bitwise_xor(a[..., :, None, :], b[..., None, :, :])
    return torch.sum(popcount_table(a.device)[x.long()], dim=-1, dtype=torch.int32)


def knn2_match(
    desc_a: torch.Tensor,  # (A, Na, 32)
    valid_a: torch.Tensor,  # (A, Na)
    desc_b: torch.Tensor,  # (A, Nb, 32)
    valid_b: torch.Tensor,  # (A, Nb)
    ratio_thr: float,
    abs_thr: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN(k=2) + Lowe ratio + absolute-distance gates. ``argmin`` takes the
    first index among equal distances; the second distance is INT32_MAX
    when only one candidate is valid; the ratio compares in float32.
    Returns (idx_b (A, Na) int32, ok (A, Na))."""
    big = torch.iinfo(torch.int32).max
    d = torch.where(valid_b[..., None, :], hamming_matrix(desc_a, desc_b), big)
    best = torch.argmin(d, dim=-1)
    d1 = torch.gather(d, -1, best[..., None])[..., 0]
    d2 = torch.amin(d.scatter(-1, best[..., None], big), dim=-1)
    ok = (
        valid_a
        & (d1 < abs_thr)
        & (d1.to(torch.float32) < ratio_thr * d2.to(torch.float32))
    )
    return best.to(torch.int32), ok
