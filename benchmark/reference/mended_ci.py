"""The descriptor fusion's covariance-intersection update with the mend of
ROADMAP C21, in plain PyTorch, for the reference's REQUEST_COMM round.

The frozen copy (``xmat_ref``) applies the joint SLAM-SLAM CI update through
an LU solve of S, as the port did before the mend. In float32 an S whose
entries span more than the precision (the own and peer landmark terms near
10^6 beside the landmark noise's 10^-2) loses its smallest direction to
rounding, and the gain turns the agent's covariance non-finite or
indefinite. The mended update solves S through its Cholesky factor and
applies nothing where S does not factorize at the working precision: a
failed factorization, a pivot no larger than the rounding unit of S's
largest diagonal entry, or a result that is not finite.

Departures from ``xmat_ref`` (everything else is the frozen copy's own):

* ``apply_ci_spd`` replaces ``ekf/ci.py:apply_ci`` in the update: Cholesky
  (``torch.linalg.cholesky_ex`` and the copy's ``ops/linalg.cholesky_solve``)
  in place of ``torch.linalg.solve_ex``, and the flag above;
* ``apply_matches`` is ``vio/updates/multi_slam.py:apply_matches`` with the
  flag folded into the kept matches (so into the applied count and the
  update's select);
* :class:`MendedReference` runs the frozen round with this ``apply_matches``
  in the place of the copy's, for the duration of each call.

Imports nothing of the port and no JAX. TF32 is off for this module's
matmuls unless a caller turns it on (the control does, around a stage)."""
from __future__ import annotations

import contextlib

import torch

from .steps import Reference
from .xmat_ref.ekf.state import correct_core, correct_vision
from .xmat_ref.ops import linalg
from .xmat_ref.utils import tree
from .xmat_ref.utils.tree import take
from .xmat_ref.vio.updates import multi_slam

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def apply_ci_spd(cov, ci_cov, h, res, s):
    """(correction, new_cov, ok): K = ci_P H^T S^-1 through the Cholesky
    factor of S, P <- sym((I - K H) ci_P); ``ok`` false where S does not
    factorize at the working precision or the result is not finite."""
    d = cov.shape[-1]
    l, info = torch.linalg.cholesky_ex(s)
    pivots = torch.diagonal(l, dim1=-2, dim2=-1) ** 2
    unit = 0.5 * torch.finfo(s.dtype).eps
    ok = (info == 0) & (pivots.amin(-1) > unit * torch.diagonal(s, dim1=-2, dim2=-1).amax(-1))
    k = _t(linalg.cholesky_solve(h @ ci_cov, l))
    correction = (k @ res[..., None])[..., 0]
    new_cov = 0.5 * ((torch.eye(d, dtype=cov.dtype, device=cov.device) - k @ h) @ ci_cov)
    new_cov = new_cov + _t(new_cov)
    ok = ok & torch.isfinite(correction).all(-1) & torch.isfinite(new_cov).flatten(-2).all(-1)
    return correction, new_cov, ok


def apply_matches(dims, core, vision, cov, other_p_arr, other_q_arr, other_f_arr, other_anchor,
                  other_lm_cov, own_fid, other_fid, match_valid, sigma_landmark, ci_slam_w):
    """One round's K SLAM-SLAM matches against one peer snapshot as a single
    joint 3K-row CI update, no update where S does not factorize. Returns
    (core, vision, cov, n_applied (A,), kept (A, K))."""
    m, d = dims.n_poses, dims.d
    dtype, dev = cov.dtype, cov.device
    a, k = own_fid.shape
    var_lm = sigma_landmark * sigma_landmark

    f = take(vision.f_arr, own_fid)
    a_idx = torch.clamp(take(vision.anchor_idx, own_fid), min=0)
    q_a = take(vision.q_arr, a_idx)
    oa = torch.clamp(take(other_anchor, other_fid), min=0)
    res_k = (multi_slam.landmark_world(take(other_f_arr, other_fid), take(other_q_arr, oa),
                                       take(other_p_arr, oa))
             - multi_slam.landmark_world(f, q_a, take(vision.p_arr, a_idx)))
    h_k = multi_slam._scatter_rows(d, m, a_idx, own_fid,
                                   *multi_slam._landmark_jac_blocks(f, q_a))
    h = h_k.reshape(a, 3 * k, d)
    res = res_k.reshape(a, 3 * k)

    s_own = h @ cov @ h.transpose(-1, -2)
    ar = torch.arange(a, device=dev)[:, None, None]
    ofid = other_fid.long()
    lam = other_lm_cov[ar, ofid[:, :, None], ofid[:, None, :]]
    lam = lam.permute(0, 1, 3, 2, 4).reshape(a, 3 * k, 3 * k)
    w = abs(ci_slam_w)
    if ci_slam_w < 0:
        own_tr = torch.diagonal(s_own, dim1=-2, dim2=-1).reshape(a, k, 3).sum(-1)
        peer_tr = torch.diagonal(lam, dim1=-2, dim2=-1).reshape(a, k, 3).sum(-1)
        match_valid = match_valid & (peer_tr < own_tr)
    eye = torch.eye(3 * k, dtype=dtype, device=dev)
    s_full = s_own / (1.0 - w) + lam / w + var_lm * eye

    s3 = torch.diagonal(s_full.reshape(a, k, 3, k, 3), dim1=1, dim2=3).permute(0, 3, 1, 2)
    r3 = res.reshape(a, k, 3)
    gamma = torch.sum(r3 * linalg.solve3(s3, r3), dim=-1)
    keep = match_valid & (gamma < multi_slam._GATE3) & torch.isfinite(r3).all(-1)
    keep3 = keep.repeat_interleave(3, dim=1)
    h = torch.where(keep3[..., None], h, 0.0)
    res = torch.where(keep3, res, 0.0)
    s_full = (torch.where(keep3[:, :, None] & keep3[:, None, :], s_full, 0.0)
              + torch.diag_embed(torch.where(keep3, 0.0, 1.0).to(dtype)))

    w_t = torch.full((), w, dtype=dtype, device=dev)
    sq = torch.sqrt(1.0 / (1.0 - w_t))
    hits = torch.zeros((a, d), dtype=torch.int32, device=dev).scatter_add(
        1, multi_slam._block_cols(m, a_idx, own_fid).reshape(a, 9 * k),
        keep.to(torch.int32).repeat_interleave(9, dim=1),
    )
    scale = torch.where(hits > 0, sq, 1.0)
    ci_p = cov * scale[:, :, None] * scale[:, None, :]
    corr, cov1, solved = apply_ci_spd(cov, ci_p, h, res, s_full)
    keep = keep & solved[:, None]
    n_app = keep.sum(1).to(torch.int32)
    do = n_app > 0
    core = tree.where(do, correct_core(core, corr), core)
    vision = tree.where(do, correct_vision(vision, corr, dims), vision)
    cov = torch.where(do[:, None, None], cov1, cov)
    return core, vision, cov, n_app, keep


@contextlib.contextmanager
def mended():
    """The frozen copy's SLAM-SLAM update replaced by :func:`apply_matches`."""
    frozen = multi_slam.apply_matches
    multi_slam.apply_matches = apply_matches
    try:
        yield
    finally:
        multi_slam.apply_matches = frozen


class MendedReference(Reference):
    """The frozen reference (``steps.Reference``) with the mended update in
    its REQUEST_COMM round."""

    def round(self, words, fs, slots, db):
        with mended():
            return super().round(words, fs, slots, db)
