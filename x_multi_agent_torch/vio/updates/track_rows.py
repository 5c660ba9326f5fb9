"""The projected, gated update rows of the filter's track builders: the
shared tail of ``msckf.build``, ``msckf_slam.build`` and ``slam.build``.

Each builder computes its per-observation blocks (residuals, pose and
feature Jacobians) in torch from small tensors, then hands them here:

  * :func:`window_rows` (MSCKF, MSCKF-SLAM): scatter each track's blocks
    into its (2M, D) Jacobian, project onto the left nullspace of its
    feature Jacobian (three Householder reflections), whiten, gate with
    chi2(2 n_obs - 3, 0.95) against the agent's covariance, zero the rows of
    rejected tracks; MSCKF-SLAM also gets the column-space rows (h1, h2, r1);
  * :func:`slam_rows` (SLAM): the 2 rows of each feature on the current
    pose, anchor pose and feature columns, gated with chi2(2 length, 0.90).

On a CUDA covariance each is one launch of the hand-written kernel
``track_rows`` (``csrc/track_rows.cu``; it replaces no Pallas kernel, the
JAX package's filter has none), which reads P's block over the columns the
rows touch once per track and writes each row once; there is no fallback.
Before it run its helpers from the same file, each with its own counter: a
finiteness pass over each agent's P (``cov_finite``) and, for the window
tracks, four launches of the reflections (``track_reflect``).
On CPU tensors each runs the plain chain beside it (:func:`_window_plain`,
:func:`_slam_plain`: the builders' dense chain), which the CPU tests hold
to the JAX package and the card's tests hold the kernel to.
"""
from __future__ import annotations

import torch

from ... import native
from ...ops import linalg
from ...utils.chi2 import chi2_gate, chi2_quantile_table
from .common import feature_col, pose_att_col, pose_pos_col, scatter_block

TRACK_ROWS = native.Kernel("track_rows")
# the window tracks' reflections on hf and res, between torch's v^T hf products
REFLECT = native.Kernel("track_reflect")
# each agent's P finite, the flag every track_rows launch reads: one before it
COV_FINITE = native.Kernel("cov_finite")

MSCKF_CONFIDENCE = 0.95
SLAM_CONFIDENCE = 0.90
_WINDOW, _SLAM = 0, 1  # the kernel's modes


def _assemble_h(j_pos, j_att, m: int, n: int, anchor_pos=None, anchor_att=None,
                anchor_onehot=None):
    """Scatter per-obs (A, K, M, 2, 3) blocks into (A, K, 2M, D) at their
    own window-slot columns (plus, optionally, anchor-slot blocks)."""
    dtype, dev = j_pos.dtype, j_pos.device
    eye_m = torch.eye(m, dtype=dtype, device=dev)
    pos_big = torch.einsum("zkmab,mn->zkmanb", j_pos, eye_m)
    att_big = torch.einsum("zkmab,mn->zkmanb", j_att, eye_m)
    if anchor_onehot is not None:
        pos_big = pos_big + torch.einsum("zkmab,zkn->zkmanb", anchor_pos, anchor_onehot)
        att_big = att_big + torch.einsum("zkmab,zkn->zkmanb", anchor_att, anchor_onehot)
    lead = j_pos.shape[:2]
    h = torch.cat(
        [
            torch.zeros(lead + (m, 2, 15), dtype=dtype, device=dev),
            pos_big.reshape(lead + (m, 2, 3 * m)),
            att_big.reshape(lead + (m, 2, 3 * m)),
            torch.zeros(lead + (m, 2, 3 * n), dtype=dtype, device=dev),
        ],
        dim=-1,
    )
    return h.reshape(lead + (2 * m, 15 + 6 * m + 3 * n))


def window_rows(res, j_pos, j_att, hf, cov, sigma_img: float, n_obs, ok, n_features: int,
                anchor=None, j_anchor_pos=None, j_anchor_att=None):
    """The nullspace-projected, gated rows of K window tracks per agent.

    res (A, K, M, 2), j_pos / j_att / hf (A, K, M, 2, 3): per-observation
    blocks, zero where unobserved; cov (A, D, D); n_obs (A, K) observation
    counts (the gate's dof is 2 n_obs - 3); ok (A, K) the builder's own
    validity. With ``anchor`` (A, K) and the anchor-pose blocks (A, K, M, 2,
    3) the rows also carry the anchor pose (MSCKF-SLAM).

    Returns (h0 (A, K, 2M-3, D), res0 (A, K, 2M-3), keep (A, K), valid
    (A, K), init): rows and residuals zero where ``keep`` is false; ``valid``
    is ``ok`` with a finite gamma; ``init`` is (h1 (A, K, 3, D), h2 (A, K, 3,
    3), r1 (A, K, 3)), unmasked, with the anchor blocks and None without.
    CUDA ``cov``: the kernel (4 <= M <= 16), or raise. There the three
    reflections are found on hf and applied to res with
    ``linalg.householder_qt``'s rounding (:func:`_reflections`), and the
    kernel applies them to the pose columns rounding as the plain chain's
    cuBLAS and elementwise steps do, so the rows come out as the plain
    chain's where cuBLAS sums v^T a in row order (the benchmark's fleets)."""
    if not cov.is_cuda:
        return _window_plain(res, j_pos, j_att, hf, cov, sigma_img, n_obs, ok, n_features,
                             anchor, j_anchor_pos, j_anchor_att)
    a, k, m = res.shape[:3]
    d = cov.shape[-1]
    if not 4 <= m <= 16:
        raise ValueError(f"track_rows: window tracks need 4 <= M <= 16 on CUDA, got {m}")
    dtype, dev = cov.dtype, cov.device
    r = 2 * m - 3
    hf_t, res_t, v, beta = _reflections(hf.reshape(a, k, 2 * m, 3), res.reshape(a, k, 2 * m))
    blocks = [("res", res_t, (a, k, 2 * m)), ("j_pos", j_pos, (a, k, m, 2, 3)),
              ("j_att", j_att, (a, k, m, 2, 3)), ("v", v, (3, a, k, 2 * m)),
              ("beta", beta, (a, k, 3))]
    if anchor is not None:
        blocks += [("j_anchor_pos", j_anchor_pos, (a, k, m, 2, 3)),
                   ("j_anchor_att", j_anchor_att, (a, k, m, 2, 3))]
    new = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    out = (new(a, k, r, d), new(a, k, r), new(a, k, dt=torch.bool), new(a, k, dt=torch.bool))
    h1 = new(a, k, 3, d) if anchor is not None else None
    _launch(_WINDOW, blocks, anchor, cov, n_obs, ok,
            chi2_quantile_table(MSCKF_CONFIDENCE, 2 * m, dtype, dev), out, h1,
            m, 2 * m, 0, sigma_img)
    init = (h1, hf_t[..., :3, :], res_t[..., :3]) if anchor is not None else None
    return out + (init,)


def _reflections(hf, res):
    """``linalg.householder_qt(hf, res)`` with each reflection's vector and
    factor: (hf_t, res_t, v (3, ..., r), beta (..., 3)), rounded as
    householder_qt rounds on the same device. The kernel applies the
    reflections to the pose columns. CPU tensors: :func:`_reflections_plain`.
    CUDA tensors (A, K, r, 3) and (A, K, r): four launches of
    ``track_reflect`` between the three v^T hf products, which stay
    ``torch.einsum`` calls (cuBLAS sums them in an order that varies with the
    batch), on copies of hf and res."""
    if hf.is_cuda:
        return _reflections_card(hf, res)
    return _reflections_plain(hf, res)


def _reflections_plain(hf, res):
    """:func:`_reflections` as householder_qt's own operations."""
    r = hf.shape[-2]
    dtype, dev = hf.dtype, hf.device
    rows = torch.arange(r, device=dev)
    a = hf
    vs, betas = [], []
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
        vm = torch.sum(v * res, dim=-1)
        res = res - beta[..., None] * (v * vm[..., None])
        vs.append(v)
        betas.append(beta)
    return a, res, torch.stack(vs), torch.stack(betas, dim=-1)


def _reflections_card(hf, res):
    a, k, r = res.shape
    if r > 32:
        raise ValueError(f"track_rows: the reflections take at most 32 rows, got {r}")
    dtype = hf.dtype
    hf, res = hf.contiguous().clone(), res.contiguous().clone()
    v = torch.empty((3, a, k, r), dtype=dtype, device=hf.device)
    beta = torch.empty((a, k, 3), dtype=dtype, device=hf.device)

    def stage(s, va=None):
        REFLECT.launch("xmat_track_reflect", hf.data_ptr(), res.data_ptr(),
                       None if va is None else va.contiguous().data_ptr(), v.data_ptr(),
                       beta.data_ptr(), s, int(dtype == torch.float64), a * k, r)

    stage(0)
    for s in range(3):
        stage(s + 1, torch.einsum("...r,...rc->...c", v[s], hf))
    return hf, res, v, beta


def slam_rows(res, j_pos, j_att, j_anchor_pos, j_anchor_att, hf, anchor_idx, cov,
              cur_pose_idx: int, sigma_img: float, track_length, ok,
              max_track_length: int):
    """The gated rows of N SLAM features per agent.

    res (A, N, 2) and the (A, N, 2, 3) blocks on the current pose, the
    anchor pose (``anchor_idx`` (A, N)) and the feature; a feature anchored
    at the current pose takes [[1, 0, 0], [0, 1, 0]] on its own columns
    instead. The gate's dof is 2 ``track_length``; ok (A, N) the builder's
    own validity. Returns (h (A, 2N, D), res (A, 2N)), zero where rejected.
    CUDA ``cov``: the kernel, or raise."""
    if not cov.is_cuda:
        return _slam_plain(res, j_pos, j_att, j_anchor_pos, j_anchor_att, hf, anchor_idx, cov,
                           cur_pose_idx, sigma_img, track_length, ok, max_track_length)
    a, n = res.shape[:2]
    d = cov.shape[-1]
    m = (d - 15 - 3 * n) // 6
    dtype, dev = cov.dtype, cov.device
    blocks = [("res", res, (a, n, 2)), ("j_pos", j_pos, (a, n, 2, 3)),
              ("j_att", j_att, (a, n, 2, 3)), ("hf", hf, (a, n, 2, 3)),
              ("j_anchor_pos", j_anchor_pos, (a, n, 2, 3)),
              ("j_anchor_att", j_anchor_att, (a, n, 2, 3))]
    rows = torch.empty((a, n, 2, d), dtype=dtype, device=dev)
    res_out = torch.empty((a, n, 2), dtype=dtype, device=dev)
    keep = torch.empty((a, n), dtype=torch.bool, device=dev)
    max_dof = 2 * max_track_length
    _launch(_SLAM, blocks, anchor_idx, cov, track_length, ok,
            chi2_quantile_table(SLAM_CONFIDENCE, max_dof, dtype, dev),
            (rows, res_out, keep, None), None, m, max_dof, int(cur_pose_idx), sigma_img)
    return rows.reshape(a, 2 * n, d), res_out.reshape(a, 2 * n)


def _launch(mode, blocks, anchor, cov, count, ok, table, out, h1, m, max_dof, cur, sigma):
    """Check the operands, then launch on the current stream the finiteness
    pass over each agent's P and the kernel once."""
    dtype = cov.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"track_rows: expected float32 or float64, got {dtype}")
    a, k = ok.shape
    d = cov.shape[-1]
    cov = cov.contiguous()
    if cov.data_ptr() % 16:  # the kernel copies P in 16-byte pieces
        cov = cov.clone()
    native.check_cuda_tensor("cov", cov, dtype, (a, d, d))
    named = dict((name, t.contiguous()) for name, t, _ in blocks)
    for name, _, shape in blocks:
        native.check_cuda_tensor(name, named[name], dtype, shape)
    count = count.to(torch.int64).contiguous()
    native.check_cuda_tensor("count", count, torch.int64, (a, k))
    native.check_cuda_tensor("ok", ok, torch.bool, (a, k))
    if anchor is not None:
        anchor = anchor.to(torch.int32).contiguous()
        native.check_cuda_tensor("anchor", anchor, torch.int32, (a, k))
    p_ok = torch.empty((a,), dtype=torch.bool, device=cov.device)
    COV_FINITE.launch("xmat_cov_finite", cov.data_ptr(), p_ok.data_ptr(),
                      int(dtype == torch.float64), a, d)

    def ptr(t):
        return None if t is None else t.data_ptr()

    TRACK_ROWS.launch(
        "xmat_track_rows",
        *(ptr(named.get(name)) for name in
          ("res", "j_pos", "j_att", "hf", "j_anchor_pos", "j_anchor_att")),
        ptr(anchor), cov.data_ptr(), p_ok.data_ptr(), count.data_ptr(), ok.data_ptr(),
        table.data_ptr(), *(ptr(t) for t in out), ptr(h1), ptr(named.get("v")),
        ptr(named.get("beta")), mode, int(dtype == torch.float64), a, k, m, d, max_dof, cur,
        float(sigma),
    )


def _window_dense(res, j_pos, j_att, hf, cov, sigma_img, n_features, anchor=None,
                  j_anchor_pos=None, j_anchor_att=None):
    """The dense chain of :func:`window_rows` up to its gate: (h0, res0,
    gamma, (h1, h2, r1)), nothing masked."""
    a, k, m, _ = res.shape
    anchor_onehot = None
    if anchor is not None:
        is_last = torch.arange(m, device=res.device) == anchor[..., None]
        anchor_onehot = is_last.to(cov.dtype)
    h = _assemble_h(j_pos, j_att, m, n_features, j_anchor_pos, j_anchor_att, anchor_onehot)
    h0, res0, h1, (r1, h2) = linalg.nullspace_project(
        hf.reshape(a, k, 2 * m, 3), h, res.reshape(a, k, 2 * m)
    )
    gamma = linalg.mahalanobis_gamma(cov[:, None], h0 / sigma_img, res0 / sigma_img)
    return h0, res0, gamma, (h1, h2, r1)


def _window_plain(res, j_pos, j_att, hf, cov, sigma_img, n_obs, ok, n_features,
                  anchor=None, j_anchor_pos=None, j_anchor_att=None):
    """:func:`window_rows` as the dense chain (CPU tensors)."""
    m = res.shape[2]
    h0, res0, gamma, init = _window_dense(res, j_pos, j_att, hf, cov, sigma_img, n_features,
                                          anchor, j_anchor_pos, j_anchor_att)
    valid = ok & torch.isfinite(gamma)
    keep = chi2_gate(gamma, 2 * n_obs - 3, MSCKF_CONFIDENCE, 2 * m) & valid
    h0 = torch.where(keep[..., None, None], h0, 0.0)
    res0 = torch.where(keep[..., None], res0, 0.0)
    return h0, res0, keep, valid, (init if anchor is not None else None)


def _slam_dense(res, j_pos, j_att, j_anchor_pos, j_anchor_att, hf, anchor_idx, cov,
                cur_pose_idx, sigma_img):
    """The dense chain of :func:`slam_rows` up to its gate: (h (A, N, 2,
    D), gamma (A, N)), nothing masked."""
    a, n = res.shape[:2]
    d = cov.shape[-1]
    m = (d - 15 - 3 * n) // 6
    dtype, dev = cov.dtype, cov.device
    a_idx = anchor_idx.long()
    h0 = torch.zeros((a, n, 2, d), dtype=dtype, device=dev)
    feat = torch.arange(n, device=dev)
    h_gen = scatter_block(h0, j_pos, pose_pos_col(cur_pose_idx, m))
    h_gen = scatter_block(h_gen, j_att, pose_att_col(cur_pose_idx, m))
    h_gen = scatter_block(h_gen, j_anchor_pos, pose_pos_col(a_idx, m))
    h_gen = scatter_block(h_gen, j_anchor_att, pose_att_col(a_idx, m))
    h_gen = scatter_block(h_gen, hf, feature_col(feat, m))
    # anchor == current pose: rows are [[1,0,0],[0,1,0]] on the feature block
    eye_blk = torch.eye(3, dtype=dtype, device=dev)[:2].expand(a, n, 2, 3)
    h_special = scatter_block(h0, eye_blk, feature_col(feat, m))
    h_all = torch.where((anchor_idx == cur_pose_idx)[..., None, None], h_special, h_gen)
    gamma = linalg.mahalanobis_gamma(cov[:, None], h_all / sigma_img, res / sigma_img)
    return h_all, gamma


def _slam_plain(res, j_pos, j_att, j_anchor_pos, j_anchor_att, hf, anchor_idx, cov,
                cur_pose_idx, sigma_img, track_length, ok, max_track_length):
    """:func:`slam_rows` as the dense chain (CPU tensors)."""
    a, n = res.shape[:2]
    h_all, gamma = _slam_dense(res, j_pos, j_att, j_anchor_pos, j_anchor_att, hf, anchor_idx,
                               cov, cur_pose_idx, sigma_img)
    inlier = chi2_gate(gamma, 2 * track_length, SLAM_CONFIDENCE, 2 * max_track_length)
    keep = ok & inlier
    h_out = torch.where(keep[..., None, None], h_all, 0.0).reshape(a, 2 * n, -1)
    res_out = torch.where(keep[..., None], res, 0.0).reshape(a, 2 * n)
    return h_out, res_out
