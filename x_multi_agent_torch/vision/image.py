"""Image pyramid + interpolation primitives (port of
``x_multi_agent_tpu.vision.image``).

pyrDown = 5-tap Gaussian [1 4 6 4 1]/16 separable blur + 2x decimation with
edge replication at the borders (the reference's choice; not OpenCV's
REFLECT_101). Every function takes images with any leading batch dims
(..., H, W).

The tracker builds its two pyramids and the previous one's Scharr gradients
through :func:`pyramids`: on CUDA tensors it launches the hand-written
kernel ``csrc/pyramid.cu`` once per level; on CPU tensors it runs the plain
versions, :func:`build_pyramid` and :func:`scharr_gradients`
(:func:`plain_pyramids`). The two are equal bit for bit: the kernel rounds
every product and sum as the plain version's full-frame ops do.
"""
from __future__ import annotations

import torch

from .. import native

PYRAMID = native.Kernel("pyramid_level")


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
    """Bilinear interpolation of images (*B, H, W) at float (x, y) positions
    pts (*B, ..., 2), each batch entry sampling its own image. Out-of-bounds
    clamps to the edge; a NaN position samples NaN (its gather index is
    clamped, so it never reads outside the image)."""
    h, w = img.shape[-2:]
    x = torch.clamp(pts[..., 0], 0.0, w - 1.001)
    y = torch.clamp(pts[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).long().clamp(0, w - 1)
    y0 = torch.floor(y).long().clamp(0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0
    fy = y - y0
    lead = img.shape[:-2]
    flat = img.reshape(lead + (h * w,))

    def at(yy, xx):
        idx = (yy * w + xx).reshape(lead + (-1,))
        return torch.gather(flat, -1, idx).reshape(yy.shape)

    v00 = at(y0, x0)
    v01 = at(y0, x1)
    v10 = at(y1, x0)
    v11 = at(y1, x1)
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


def plain_pyramids(prev: torch.Tensor, cur: torch.Tensor, depth: int):
    """The plain version of :func:`pyramids`."""
    pyr_prev = build_pyramid(prev, depth)
    return pyr_prev, build_pyramid(cur, depth), [scharr_gradients(lvl) for lvl in pyr_prev]


def pyramids(prev: torch.Tensor, cur: torch.Tensor, depth: int):
    """The ``depth + 1``-level pyramids of two (A, H, W) image batches and
    the Scharr gradients of each level of the first: (pyr_prev, pyr_cur,
    [(dx, dy)] per level of pyr_prev), level 0 the inputs themselves.

    CPU tensors: :func:`plain_pyramids`. CUDA tensors: the kernel
    ``pyramid_level_kernel``, one launch per level for both images (float32,
    contiguous, equal shapes), or raise."""
    if not prev.is_cuda:
        return plain_pyramids(prev, cur, depth)
    native.check_cuda_tensor("prev", prev, torch.float32)
    if prev.dim() != 3:
        raise ValueError(f"prev: expected (A, H, W), got {tuple(prev.shape)}")
    native.check_cuda_tensor("cur", cur, torch.float32, prev.shape)
    pyr_prev, pyr_cur, grads = [prev], [cur], []
    for lvl in range(depth + 1):
        src_prev, src_cur = pyr_prev[-1], pyr_cur[-1]
        a, h, w = src_prev.shape
        dx, dy = torch.empty_like(src_prev), torch.empty_like(src_prev)
        more = lvl < depth  # the next level too, of both images
        if more:
            pyr_prev.append(prev.new_empty((a, (h + 1) // 2, (w + 1) // 2)))
            pyr_cur.append(torch.empty_like(pyr_prev[-1]))
        nxt = (pyr_prev[-1].data_ptr(), pyr_cur[-1].data_ptr()) if more else (0, 0)
        PYRAMID.launch("xmat_pyramid_level", src_prev.data_ptr(), src_cur.data_ptr(), *nxt,
                       dx.data_ptr(), dy.data_ptr(), a, h, w, int(more))
        grads.append((dx, dy))
    return pyr_prev, pyr_cur, grads
