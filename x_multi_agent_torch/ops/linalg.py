"""EKF linear-algebra building blocks (port of ``x_multi_agent_tpu.ops.linalg``).

Fixed-shape, mask-aware, batched over any leading dims:
  * left-nullspace projection of the feature Jacobian (Householder);
  * Gram/Cholesky measurement compression of the whitened [H | res];
  * the (I)EKF gain/covariance update.

Row masking convention: disabled measurement rows are identically zero in H
*and* res; zero rows survive every orthogonal transform as zero-information
rows, so padding never changes the update.

Precision: the reference wraps its covariance algebra in ``highprec`` to
force full-precision float32 matmuls on the TPU. On the card the same rule is
global: TF32 stays off (``torch.backends.cuda.matmul.allow_tf32 = False``),
so every float32 matmul here is already full precision and ``highprec`` has
no counterpart. The reference's TPU-only workarounds (Newton-Schulz inverse,
Neumann triangular solves, unrolled Cholesky) are not ported: SPD solves use
``torch.linalg.cholesky_ex`` + two triangular solves (:func:`cholesky_solve`).
"""
from __future__ import annotations

from typing import Tuple

import torch


def require_fp32_matmul(device: torch.device, what: str) -> None:
    """Raise when filter algebra would run on a CUDA ``device`` with TF32
    matmuls on (its covariance needs full fp32)."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError(f"{what} needs TF32 matmuls off on CUDA "
                         "(torch.backends.cuda.matmul.allow_tf32 = False)")


def symmetrize(p: torch.Tensor) -> torch.Tensor:
    return 0.5 * (p + p.transpose(-1, -2))


def solve3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 solve (Cramer via cross products of the columns)."""
    a0, a1, a2 = a[..., :, 0], a[..., :, 1], a[..., :, 2]
    c0 = torch.linalg.cross(a1, a2)
    c1 = torch.linalg.cross(a2, a0)
    c2 = torch.linalg.cross(a0, a1)
    det = torch.sum(a0 * c0, dim=-1)
    safe = torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det))
    num = torch.stack(
        [torch.sum(c0 * b, dim=-1), torch.sum(c1 * b, dim=-1), torch.sum(c2 * b, dim=-1)],
        dim=-1,
    )
    return num / safe[..., None]


def inv3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate over determinant), batched."""
    a0, a1, a2 = a[..., :, 0], a[..., :, 1], a[..., :, 2]
    c0 = torch.linalg.cross(a1, a2)
    c1 = torch.linalg.cross(a2, a0)
    c2 = torch.linalg.cross(a0, a1)
    det = torch.sum(a0 * c0, dim=-1)
    safe = torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det))
    return torch.stack([c0, c1, c2], dim=-2) / safe[..., None, None]


def householder_qt(hf: torch.Tensor, *mats):
    """Apply Q^T (from the QR of the (..., r, 3) matrix ``hf``) to each of
    ``mats`` with three explicit Householder reflections. Each of ``mats``
    is a matrix (..., r, d) or a vector (..., r). Rank-deficient columns skip
    their reflection (beta = 0). Returns (hf_transformed, *mats_t)."""
    r = hf.shape[-2]
    dtype, dev = hf.dtype, hf.device
    rows = torch.arange(r, device=dev)
    a = hf
    outs = list(mats)
    for k in range(hf.shape[-1]):
        x = torch.where(rows >= k, a[..., :, k], torch.zeros((), dtype=dtype, device=dev))
        norm = torch.sqrt(torch.sum(x * x, dim=-1))
        sign = torch.where(x[..., k] >= 0, 1.0, -1.0).to(dtype)
        alpha = -sign * norm
        v = x - alpha[..., None] * (rows == k).to(dtype)
        vn2 = torch.sum(v * v, dim=-1)
        big = vn2 > 1e-24
        beta = torch.where(big, 2.0 / torch.where(big, vn2, torch.ones_like(vn2)),
                           torch.zeros_like(vn2))
        va = torch.einsum("...r,...rc->...c", v, a)
        a = a - beta[..., None, None] * (v[..., :, None] * va[..., None, :])
        new = []
        for m in outs:
            if m.dim() == hf.dim():
                vm = torch.einsum("...r,...rc->...c", v, m)
                new.append(m - beta[..., None, None] * (v[..., :, None] * vm[..., None, :]))
            else:
                vm = torch.sum(v * m, dim=-1)
                new.append(m - beta[..., None] * (v * vm[..., None]))
        outs = new
    return (a, *outs)


def nullspace_project(hf: torch.Tensor, h: torch.Tensor, res: torch.Tensor):
    """Project (h, res) onto the left nullspace of ``hf`` (..., r, 3); also
    return the column-space projections used by MSCKF-SLAM init (Li 2012).

    Returns (h0 (..., r-3, d), res0 (..., r-3), h1 (..., 3, d),
    (r1 (..., 3), h2 (..., 3, 3)))."""
    hf_t, h_t, res_t = householder_qt(hf, h, res)
    return h_t[..., 3:, :], res_t[..., 3:], h_t[..., :3, :], (res_t[..., :3], hf_t[..., :3, :])


def cholesky_solve(b: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """S^-1 b from the lower Cholesky factor ``l`` of S: two triangular
    solves (cuBLAS's batched TRSM on the card). ``torch.cholesky_solve`` on
    a batch goes to MAGMA there, which allocates during the call, so a CUDA
    graph cannot hold it."""
    y = torch.linalg.solve_triangular(l, b, upper=False)
    return torch.linalg.solve_triangular(l.transpose(-1, -2), y, upper=True)


def spd_solve_ex(s: torch.Tensor, b: torch.Tensor):
    """(S^-1 b, ok (...)) for SPD ``s`` (..., n, n), b (..., n, r): ``ok``
    is false where the Cholesky factorization failed (``s`` not positive
    definite to rounding); the solve's output is undefined there."""
    l, info = torch.linalg.cholesky_ex(s)
    return cholesky_solve(b, l), info == 0


def spd_solve(s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S^-1 b for SPD ``s`` (..., n, n), b (..., n, r); NaN where ``s`` does
    not factorize, so that a gate on the result rejects it."""
    x, ok = spd_solve_ex(s, b)
    return torch.where(ok[..., None, None], x, float("nan"))


def qr_compress(
    h: torch.Tensor, res: torch.Tensor, noise_std: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whitened measurement compression via the Gram matrix.

    Rows are whitened by their own std; the Kalman update depends on them
    only through G = [H|r]^T [H|r], so R = chol(G)^T (Jacobi-equilibrated,
    tiny relative ridge) gives the identical update with implicit R = I.
    h: (..., r, d), res/noise_std: (..., r). Returns ((..., d, d), (..., d))."""
    d = h.shape[-1]
    dtype = h.dtype
    w = 1.0 / noise_std
    aug = torch.cat([h * w[..., :, None], (res * w)[..., :, None]], dim=-1)
    g = aug.transpose(-1, -2) @ aug  # (..., d+1, d+1)
    diag = torch.diagonal(g, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-20))
    gs = g * s[..., :, None] * s[..., None, :]
    ridge = 1e-6 if dtype == torch.float32 else 1e-12
    l, info = torch.linalg.cholesky_ex(
        gs + ridge * torch.eye(d + 1, dtype=dtype, device=h.device)
    )
    r_fact = l.transpose(-1, -2) * (1.0 / s)[..., None, :]
    # a failed factorization is all-NaN in the reference, then zeroed
    good = (info == 0)[..., None, None] & torch.isfinite(r_fact)
    r_fact = torch.where(good, r_fact, torch.zeros_like(r_fact))
    return r_fact[..., :d, :d], r_fact[..., :d, d]


def whiten(h: torch.Tensor, res: torch.Tensor, noise_std: torch.Tensor):
    w = 1.0 / noise_std
    return h * w[..., :, None], res * w


def kalman_update(
    cov: torch.Tensor,  # (..., d, d)
    h: torch.Tensor,  # (..., r, d) whitened
    res: torch.Tensor,  # (..., r)
    correction_total: torch.Tensor,  # (..., d)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (I)EKF update with whitened rows (R = I):
      S = H P H^T + I ;  K = P H^T S^-1
      correction = K (res + H corr_tot) - corr_tot
      P <- sym((I - K H) P (I - K H)^T + K K^T)   (Joseph form)
    Returns (correction, new_cov).

    The reference updates P <- sym((I - K H) P), equal to the Joseph form
    in exact arithmetic for this K. In float32 a covariance can leave the
    PSD cone by rounding (a feature inserted with a large variance leaves a
    negative eigenvalue at rounding level); once an update has shrunk the
    large variance, that eigenvalue is no longer small beside the rest,
    later updates grow it, and S stops factorizing: the reference's form
    then turns the agent's covariance non-finite, as the reference itself
    does in float32 (ROADMAP C20). The Joseph form, a sum of two PSD
    products, lets fewer agents get there; an agent whose S does not
    factorize gets no update (K = 0: the correction undoes
    ``correction_total`` and P is kept), so its covariance stays finite."""
    d = cov.shape[-1]
    eye_r = torch.eye(h.shape[-2], dtype=cov.dtype, device=cov.device)
    pht = cov @ h.transpose(-1, -2)
    s = h @ pht + eye_r
    k, ok = spd_solve_ex(s, pht.transpose(-1, -2))
    k = torch.where(ok[..., None, None], k, 0.0).transpose(-1, -2)
    inn = res + (h @ correction_total[..., None])[..., 0]
    correction = (k @ inn[..., None])[..., 0] - correction_total
    eye_d = torch.eye(d, dtype=cov.dtype, device=cov.device)
    ikh = eye_d - k @ h
    new_cov = symmetrize(ikh @ cov @ ikh.transpose(-1, -2) + k @ k.transpose(-1, -2))
    return correction, new_cov


def mahalanobis_gamma(cov: torch.Tensor, h: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """gamma = res^T (H P H^T + I)^-1 res for whitened rows (..., r, d);
    closed forms for r <= 3."""
    r = h.shape[-2]
    eye_r = torch.eye(r, dtype=cov.dtype, device=cov.device)
    s = h @ (cov @ h.transpose(-1, -2)) + eye_r
    if r == 1:
        return res[..., 0] * res[..., 0] / s[..., 0, 0]
    if r == 2:
        det = s[..., 0, 0] * s[..., 1, 1] - s[..., 0, 1] * s[..., 1, 0]
        det = torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det))
        return (
            res[..., 0] * (s[..., 1, 1] * res[..., 0] - s[..., 0, 1] * res[..., 1])
            + res[..., 1] * (s[..., 0, 0] * res[..., 1] - s[..., 1, 0] * res[..., 0])
        ) / det
    if r == 3:
        return torch.sum(res * solve3(s, res), dim=-1)
    return torch.sum(res * spd_solve(s, res[..., None])[..., 0], dim=-1)
