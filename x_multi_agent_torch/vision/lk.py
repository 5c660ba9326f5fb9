"""Pyramidal Lucas-Kanade optical flow, Bouguet (port of
``x_multi_agent_tpu.vision.lk``).

Each pyramid level goes through :func:`track_level`: on CUDA tensors it
launches the hand-written kernel K2 (``csrc/lk.cu``, replacing the Pallas
kernels ``vision/pallas_lk2.py:track_level`` and ``vision/pallas_lk.py:
track_level`` for every ``half_win``); on CPU tensors it runs the plain
version beside it, :func:`_track_level`.

Because the LK window offsets are integers, the bilinear fraction is
constant per feature, so each feature needs one (w+1)x(w+1) slab per image
and interpolation is four shifted slices of the slab. Levels behave as if
edge-padded by ``half_win + 1``, with the slab base clamped into the padded
image (the reference's ``dynamic_slice`` clamp); indices are clamped into
the unpadded image instead of building padded copies.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import native
from .image import scharr_gradients

K2 = native.Kernel("lk_level")


def _interp_patch(p: torch.Tensor, fx, fy, w: int) -> torch.Tensor:
    """Constant-fraction bilinear of (..., w+1, w+1) slabs -> (..., w, w);
    fx, fy broadcast over the leading dims."""
    fx = fx[..., None, None]
    fy = fy[..., None, None]
    return (
        p[..., 0:w, 0:w] * (1 - fx) * (1 - fy)
        + p[..., 0:w, 1 : w + 1] * fx * (1 - fy)
        + p[..., 1 : w + 1, 0:w] * (1 - fx) * fy
        + p[..., 1 : w + 1, 1 : w + 1] * fx * fy
    )


def _level_sampler(img_shape, half_win: int, device):
    """(base, slab) of one level: ``base(pt)`` gives the padded slab origin
    floor(pt - h) + pad and the bilinear fractions; ``slab(img, by, bx)``
    gathers the (A, K, p, p) slabs with the origin clamped into the padded
    image and each index clamped into the unpadded one (edge padding)."""
    a, h_img, w_img = img_shape
    p = 2 * half_win + 2
    pad = half_win + 1
    hp, wp = h_img + 2 * pad, w_img + 2 * pad
    ar = torch.arange(a, device=device)[:, None, None, None]
    offs = torch.arange(p, device=device)

    def base(pt_xy):
        bx = torch.floor(pt_xy[..., 0] - half_win)
        by = torch.floor(pt_xy[..., 1] - half_win)
        fx = pt_xy[..., 0] - half_win - bx
        fy = pt_xy[..., 1] - half_win - by
        return by.long() + pad, bx.long() + pad, fx, fy

    def slab(img, by, bx):
        by = torch.clamp(by, 0, hp - p)
        bx = torch.clamp(bx, 0, wp - p)
        rows = torch.clamp(by[..., None] + offs - pad, 0, h_img - 1)
        cols = torch.clamp(bx[..., None] + offs - pad, 0, w_img - 1)
        return img[ar, rows[..., :, None], cols[..., None, :]]

    return base, slab


def _structure(dx_prev, dy_prev, pts, half_win: int):
    """Gradient windows (ix, iy) and the structure tensor's min eigenvalue
    per window pixel, min_eig / (2h+1)^2, plus (gxx, gxy, gyy)."""
    w = 2 * half_win + 1
    base, slab = _level_sampler(dx_prev.shape, half_win, dx_prev.device)
    by, bx, fx, fy = base(pts)
    ix = _interp_patch(slab(dx_prev, by, bx), fx, fy, w)
    iy = _interp_patch(slab(dy_prev, by, bx), fx, fy, w)
    gxx = torch.sum(ix * ix, dim=(-2, -1))
    gxy = torch.sum(ix * iy, dim=(-2, -1))
    gyy = torch.sum(iy * iy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) * 0.5
    return ix, iy, (gxx, gxy, gyy, det), min_eig / (w * w)


def _track_level(
    img_prev: torch.Tensor,  # (A, H, W)
    img_cur: torch.Tensor,
    dx_prev: torch.Tensor,
    dy_prev: torch.Tensor,
    pts_prev: torch.Tensor,  # (A, K, 2) at this level's scale
    guess: torch.Tensor,  # (A, K, 2) current flow guess at this level
    half_win: int,
    n_iters: int,
    min_eig_thr: float,
    eps: float = 0.01,
    return_iters: bool = False,
):
    """One pyramid level of LK for all features (plain version of K2).
    Returns (flow (A,K,2), ok (A,K)), and with ``return_iters`` also the
    Gauss-Newton steps each feature took (A,K)."""
    w = 2 * half_win + 1
    dtype = img_prev.dtype
    base, slab = _level_sampler(img_prev.shape, half_win, img_prev.device)
    pt = pts_prev.to(dtype)
    by, bx, fx, fy = base(pt)
    patch_prev = _interp_patch(slab(img_prev, by, bx), fx, fy, w)
    ix, iy, (gxx, gxy, gyy, det), score = _structure(dx_prev, dy_prev, pt, half_win)
    ok = score > min_eig_thr
    det_safe = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))

    # OpenCV termcrit semantics: apply dnu, stop once |dnu|^2 <= eps^2
    nu = guess.to(dtype)
    d2 = torch.full_like(gxx, 1e9)
    iters = torch.zeros(gxx.shape, dtype=torch.int32, device=gxx.device)
    for _ in range(n_iters):
        active = d2 > eps * eps
        iters = iters + active.to(torch.int32)
        byc, bxc, fxc, fyc = base(pt + nu)
        patch_cur = _interp_patch(slab(img_cur, byc, bxc), fxc, fyc, w)
        di = patch_prev - patch_cur
        bx_ = torch.sum(di * ix, dim=(-2, -1))
        by_ = torch.sum(di * iy, dim=(-2, -1))
        dnu = torch.stack([gyy * bx_ - gxy * by_, gxx * by_ - gxy * bx_], dim=-1)
        dnu = dnu / det_safe[..., None]
        dnu = torch.where(active[..., None], dnu, torch.zeros_like(dnu))
        nu = nu + dnu
        d2 = torch.where(active, torch.sum(dnu * dnu, dim=-1), d2)
    return (nu, ok, iters) if return_iters else (nu, ok)


def gate_margin(dx_prev, dy_prev, pts_prev, half_win: int, min_eig_thr: float):
    """Relative distance of each feature's min-eigenvalue score from the
    gate, ``(min_eig / w^2) / min_eig_thr - 1`` (A, K): where it is near 0,
    float32 summation order may flip ``ok`` between two correct versions."""
    score = _structure(dx_prev, dy_prev, pts_prev.to(dx_prev.dtype), half_win)[3]
    return score / min_eig_thr - 1.0


def flow_sensitivity(
    img_prev, img_cur, dx_prev, dy_prev, pts_prev, guess,
    half_win: int, n_iters: int, min_eig_thr: float, eps: float = 0.01, step: float = 1e-5,
):
    """The plain version in float64 on the given inputs, and how far its flow
    moves when each point moves by ``step`` px along +-x and +-y.

    Returns (flow64 (A,K,2), sens (A,K), the largest of the four moves).
    ``step`` is the float32 spacing of a pixel coordinate near 100-200, so
    where ``sens`` exceeds a flow tolerance the flow is not fixed by its
    inputs at float32 resolution (windows on the replicated edge whose
    Gauss-Newton steps run away), and two correct float32 versions may
    differ by about ``sens`` there."""
    imgs = [t.double() for t in (img_prev, img_cur, dx_prev, dy_prev)]
    pts, g = pts_prev.double(), guess.double()
    args = (half_win, n_iters, min_eig_thr, eps)
    flow64 = _track_level(*imgs, pts, g, *args)[0]
    sens = torch.zeros(pts.shape[:-1], dtype=torch.float64, device=pts.device)
    for d in ((step, 0.0), (-step, 0.0), (0.0, step), (0.0, -step)):
        moved = _track_level(*imgs, pts + pts.new_tensor(d), g, *args)[0]
        sens = torch.maximum(sens, torch.linalg.norm(moved - flow64, dim=-1))
    return flow64, sens


def level_agreement(flow_ref, ok_ref, flow, ok, margin, compare=None) -> dict:
    """How far a level's kernel output (flow, ok) is from the plain version's
    (flow_ref, ok_ref), in the terms the card checks use: the share of
    ``ok`` flags that agree, the largest gate margin among disagreements,
    and flow differences where both are ok (max, and share within 1e-3 px),
    restricted to the features where ``compare`` (A, K) is True when given."""
    agree = ok_ref == ok
    both = ok_ref & ok
    if compare is not None:
        both = both & compare
    err = torch.linalg.norm(flow_ref - flow, dim=-1)[both]
    dis = torch.abs(margin[~agree])
    return {
        "ok_agree": float(agree.float().mean()),
        "max_disagree_margin": float(dis.max()) if dis.numel() else 0.0,
        "max_flow_err": float(err.max()) if err.numel() else 0.0,
        "share_within_1e-3": float((err <= 1e-3).float().mean()) if err.numel() else 1.0,
        "n_both_ok": int(both.sum()),
    }


def track_level(
    img_prev, img_cur, dx_prev, dy_prev, pts_prev, guess,
    half_win: int, n_iters: int, min_eig_thr: float, eps: float = 0.01,
):
    """One LK level. CPU tensors: :func:`_track_level`. CUDA tensors:
    kernel K2 (float32, contiguous), or raise."""
    if not img_prev.is_cuda:
        return _track_level(
            img_prev, img_cur, dx_prev, dy_prev, pts_prev, guess,
            half_win, n_iters, min_eig_thr, eps,
        )
    a, h, w = img_prev.shape
    k = pts_prev.shape[1]
    for name, t in (("img_prev", img_prev), ("img_cur", img_cur),
                    ("dx_prev", dx_prev), ("dy_prev", dy_prev)):
        native.check_cuda_tensor(name, t, torch.float32, (a, h, w))
    for name, t in (("pts_prev", pts_prev), ("guess", guess)):
        native.check_cuda_tensor(name, t, torch.float32, (a, k, 2))
    flow = torch.empty((a, k, 2), dtype=torch.float32, device=img_prev.device)
    ok = torch.empty((a, k), dtype=torch.bool, device=img_prev.device)
    K2.launch(
        "xmat_lk_level",
        img_prev.data_ptr(), img_cur.data_ptr(), dx_prev.data_ptr(),
        dy_prev.data_ptr(), pts_prev.data_ptr(), guess.data_ptr(),
        flow.data_ptr(), ok.data_ptr(),
        a, h, w, k, int(half_win), int(n_iters),
        float(min_eig_thr), float(eps * eps),
    )
    return flow, ok


def track(
    pyr_prev: Sequence[torch.Tensor],  # levels of (A, H_l, W_l)
    pyr_cur: Sequence[torch.Tensor],
    pts_prev: torch.Tensor,  # (A, K, 2) pixel coords at level 0
    valid: torch.Tensor,  # (A, K)
    half_win: int = 10,
    n_iters: int = 10,
    min_eig_thr: float = 1e-4,
    eps: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track points from the previous to the current pyramid.

    Returns (pts_cur (A,K,2), ok (A,K)). Points out of bounds or failing the
    min-eigenvalue gate are flagged."""
    n_levels = len(pyr_prev)
    flow = torch.zeros_like(pts_prev)
    ok = valid
    grads = [scharr_gradients(lvl) for lvl in pyr_prev]
    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0**lvl
        pts_l = (pts_prev / scale).contiguous()
        flow = flow * 2.0 if lvl < n_levels - 1 else flow / scale
        dx, dy = grads[lvl]
        flow, lvl_ok = track_level(
            pyr_prev[lvl].contiguous(), pyr_cur[lvl].contiguous(),
            dx.contiguous(), dy.contiguous(), pts_l, flow.contiguous(),
            half_win, n_iters, min_eig_thr, eps,
        )
        ok = ok & lvl_ok
    pts_cur = pts_prev + flow * 1.0
    h, w = pyr_prev[0].shape[-2:]
    margin = half_win
    inb = (
        (pts_cur[..., 0] >= margin)
        & (pts_cur[..., 0] < w - margin)
        & (pts_cur[..., 1] >= margin)
        & (pts_cur[..., 1] < h - margin)
    )
    return pts_cur, ok & inb & valid
