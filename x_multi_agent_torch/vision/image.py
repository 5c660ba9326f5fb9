"""Image pyramid + interpolation primitives (port of
``x_multi_agent_tpu.vision.image``).

pyrDown = 5-tap Gaussian [1 4 6 4 1]/16 separable blur + 2x decimation with
edge replication at the borders (the reference's choice; not OpenCV's
REFLECT_101). Every function takes images with any leading batch dims
(..., H, W).
"""
from __future__ import annotations

import torch


def _pad_edge(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Edge-replicate the last two axes by (rows, cols) on each side."""
    if rows:
        x = torch.cat([x[..., :1, :].expand(*x.shape[:-2], rows, x.shape[-1]), x,
                       x[..., -1:, :].expand(*x.shape[:-2], rows, x.shape[-1])], dim=-2)
    if cols:
        x = torch.cat([x[..., :, :1].expand(*x.shape[:-1], cols), x,
                       x[..., :, -1:].expand(*x.shape[:-1], cols)], dim=-1)
    return x


def _sep_stencil(img: torch.Tensor, kr, kc) -> torch.Tensor:
    """Separable small stencil as shift-and-add over slices of an
    edge-padded image (same term order as the reference)."""
    h, w = img.shape[-2:]
    rr = len(kr) // 2
    rc = len(kc) // 2
    x = _pad_edge(img, rr, 0)
    out = None
    for i, k in enumerate(kr):
        if k == 0.0:
            continue
        term = x[..., i : i + h, :] * k
        out = term if out is None else out + term
    x = _pad_edge(out, 0, rc)
    out = None
    for j, k in enumerate(kc):
        if k == 0.0:
            continue
        term = x[..., :, j : j + w] * k
        out = term if out is None else out + term
    return out


def _sep_blur5(img: torch.Tensor) -> torch.Tensor:
    k = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]
    return _sep_stencil(img, k, k)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyramid level: blur then take every other pixel."""
    return _sep_blur5(img)[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, depth: int):
    """List of ``depth + 1`` levels (level 0 = input)."""
    levels = [img]
    for _ in range(depth):
        levels.append(pyr_down(levels[-1]))
    return levels


def bilinear_sample(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of one (H, W) image at float (x, y) positions
    pts (..., 2). Out-of-bounds clamps to the edge."""
    h, w = img.shape
    x = torch.clamp(pts[..., 0], 0.0, w - 1.001)
    y = torch.clamp(pts[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def scharr_gradients(img: torch.Tensor):
    """(dx, dy) image gradients with the 3x3 Scharr operator."""
    gk = [3.0 / 32, 10.0 / 32, 3.0 / 32]
    dk = [-1.0, 0.0, 1.0]
    dx = _sep_stencil(img, gk, dk)
    dy = _sep_stencil(img, dk, gk)
    return dx, dy

