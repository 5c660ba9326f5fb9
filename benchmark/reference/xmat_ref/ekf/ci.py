"""Covariance intersection (port of ``x_multi_agent_tpu.ekf.ci``).

Two variants, batched over any leading dims:
  * pairwise SLAM fusion: S = 1/(1-w) H_a P_a H_a^T + 1/w H_b P_b H_b^T,
    w_result = 1/(1-w); a negative w requests a fixed-iteration
    golden-section search of w minimizing log det S;
  * N-way MSCKF fusion: S = sum_i (1/w_i) H_i P_i H_i^T with fixed weights,
    and the multiplicative fixed-point weight solve of
    :func:`optimize_weights_nway`.

The solves use the ``_ex`` forms of ``torch.linalg`` (no error check), so
none of them waits for the card: a singular system gives non-finite values,
as in the reference, and the callers gate on finiteness.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def fuse_pairwise(cov_a, h_a, cov_b, h_b, w_other: float, n_opt_iters: int = 16):
    """Returns (S, w_result) from the peer's full covariance ``cov_b``."""
    p_b = h_b @ cov_b @ _t(h_b)
    return fuse_pairwise_proj(cov_a, h_a, p_b, w_other, n_opt_iters)


def fuse_pairwise_proj(
    cov_a: torch.Tensor,  # (..., D, D)
    h_a: torch.Tensor,  # (..., r, D)
    p_b: torch.Tensor,  # (..., r, r) peer term already projected: H_b P_b H_b^T
    w_other: float,
    n_opt_iters: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fuse_pairwise` with the peer term projected. ``w_other`` < 0
    searches w in [1e-4, 1 - 1e-4] by ``n_opt_iters`` golden-section steps
    on log det S(w). Returns (S, w_result)."""
    p_a = h_a @ cov_a @ _t(h_a)
    dtype, dev = cov_a.dtype, cov_a.device
    lead = p_a.shape[:-2]
    if w_other >= 0:
        w = torch.full(lead, w_other, dtype=dtype, device=dev)
    else:
        def obj(w):
            return torch.linalg.slogdet(
                p_a / (1.0 - w)[..., None, None] + p_b / w[..., None, None]
            ).logabsdet

        lo = torch.full(lead, 1e-4, dtype=dtype, device=dev)
        hi = torch.full(lead, 1.0 - 1e-4, dtype=dtype, device=dev)
        gr = 0.6180339887498949
        for _ in range(n_opt_iters):
            x1 = hi - gr * (hi - lo)
            x2 = lo + gr * (hi - lo)
            right = obj(x1) > obj(x2)
            lo, hi = torch.where(right, x1, lo), torch.where(right, hi, x2)
        w = 0.5 * (lo + hi)
    s = p_a / (1.0 - w)[..., None, None] + p_b / w[..., None, None]
    return s, 1.0 / (1.0 - w)


def optimize_weights_nway(
    m_own: torch.Tensor,  # (..., r, r) own information-like H P^-1 H^T
    m_others: torch.Tensor,  # (..., K, r, r)
    valid_other: torch.Tensor,  # (..., K)
    w_fallback: float,
    n_iters: int = 30,
) -> torch.Tensor:
    """Maximize log det(sum_i w_i M_i) over the simplex (bounds [1e-4, 1])
    by the multiplicative fixed point w_i <- w_i tr(S^-1 M_i) / r, which
    keeps sum w = 1. Falls back to the fixed weights (w_0 = 1 - K w, w_i =
    w) when the iteration ends non-finite or with w_0 <= 0.

    Returns w (..., K+1): [w_own, w_peer_0, ...]; invalid peers get 0."""
    dtype, dev = m_own.dtype, m_own.device
    r = m_own.shape[-1]
    ridge = 1e-8 * torch.eye(r, dtype=dtype, device=dev)
    m_stack = torch.cat([(m_own + ridge)[..., None, :, :], m_others + ridge], dim=-3)
    valid = torch.cat(
        [torch.ones_like(valid_other[..., :1], dtype=torch.bool), valid_other.bool()], dim=-1
    )
    m_stack = torch.where(valid[..., None, None], m_stack, 0.0)
    nv = valid.sum(-1, keepdim=True).to(dtype)
    w = torch.where(valid, 1.0 / nv, 0.0)
    for _ in range(n_iters):
        s = torch.einsum("...k,...kij->...ij", w, m_stack)
        sinv = torch.linalg.inv_ex(s).inverse
        tr = torch.einsum("...ij,...kji->...k", sinv, m_stack)
        w = w * tr / r
        w = torch.where(valid, torch.clamp(w, 1e-4, 1.0), 0.0)
        w = w / w.sum(-1, keepdim=True)
    k_eff = valid_other.bool().sum(-1, keepdim=True).to(dtype)
    w_fixed = torch.where(valid, torch.full_like(w, w_fallback), 0.0)
    w_fixed = torch.cat([1.0 - k_eff * w_fallback, w_fixed[..., 1:]], dim=-1)
    ok = torch.isfinite(w).all(-1, keepdim=True) & (w[..., :1] > 0)
    return torch.where(ok, w, w_fixed)


def fuse_nway(
    cov_own: torch.Tensor,  # (..., D, D)
    h_own: torch.Tensor,  # (..., r, D)
    covs_other: torch.Tensor,  # (..., K, Do, Do)
    hs_other: torch.Tensor,  # (..., K, r, Do)
    valid_other: torch.Tensor,  # (..., K)
    w_other: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """N-way CI with fixed weights w_0 = 1 - K w_other for self, w_other per
    valid peer. Returns (S, w_result = 1/w_0)."""
    k_eff = valid_other.bool().sum(-1).to(cov_own.dtype)
    w0 = 1.0 - k_eff * w_other
    s = (1.0 / w0)[..., None, None] * (h_own @ cov_own @ _t(h_own))
    peer = (1.0 / w_other) * (hs_other @ covs_other @ _t(hs_other))
    s = s + torch.where(valid_other.bool()[..., None, None], peer, 0.0).sum(-3)
    return s, 1.0 / w0


def apply_ci(
    cov: torch.Tensor,  # (..., D, D)
    ci_cov: torch.Tensor,  # (..., D, D)
    h: torch.Tensor,  # (..., r, D)
    res: torch.Tensor,  # (..., r)
    s: torch.Tensor,  # (..., r, r)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CI Kalman application: K = ci_P H^T S^-1, P <- sym((I - K H) ci_P).
    LU, not Cholesky: the CI-weighted S need not be PSD with respect to
    ci_P. Returns (correction, new_cov)."""
    d = cov.shape[-1]
    k = _t(torch.linalg.solve_ex(s, h @ ci_cov).result)
    correction = (k @ res[..., None])[..., 0]
    new_cov = 0.5 * ((torch.eye(d, dtype=cov.dtype, device=cov.device) - k @ h) @ ci_cov)
    return correction, new_cov + _t(new_cov)
