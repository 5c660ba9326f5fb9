"""Online thermal photometric calibration (port of
``x_multi_agent_tpu.photometric.calib``; Das et al.).

  * per frame-pair affine gains (a, b) fitted to tracked-feature intensity
    pairs with the residual  o - (o' (a-b) + b)  and the regularizers
    0.1 (a-1), 0.1 b: linear in (a, b), so each fit is a 2x2 normal-equation
    solve (closed form here);
  * RANSAC over 4-point fits, vote threshold 8e-3, refit on the best
    inlier set, as one batch over the histories and the hypotheses;
  * gain chaining, relative gains and the epsilon_gap / epsilon_base drift
    anchoring;
  * multi-history aggregation weighted by inlier support;
  * spatial per-cell offsets from a +1/-1 difference system (dense
    Tikhonov normal equations) smoothed by SE-kernel Gaussian-process
    regression;
  * image correction, plain clipped or with the cyclic fold + triangular LUT.

The RANSAC sample indices are an INPUT (``idx``): the reference draws them
with ``jax.random.categorical`` under ``PRNGKey(frame)``, whose bits torch
cannot reproduce. Callers draw them with ``ops.ransac.KeyedSampler(seed,
N_HYPOTHESES, SAMPLE_SIZE)``, keyed on the frame and the history as the
reference is, or pass the reference's own draws in parity tests. Nothing
here reads a tensor back to the host.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from ..device import resolve

REG_W = 0.1
RANSAC_THR = 8.0e-3
N_HYPOTHESES = 32  # RANSAC hypotheses per history frame
SAMPLE_SIZE = 4  # intensity pairs per hypothesis


# ---------------------------------------------------------------------------
# gain algebra
# ---------------------------------------------------------------------------


def relative_gains(a1, b1, a2, b2):
    e12 = (a2 - b2) / (a1 - b1)
    b12 = (b2 - b1) / (a1 - b1)
    return e12 + b12, b12


def chain_gains(a01, b01, a12, b12):
    e02 = (a01 - b01) * (a12 - b12)
    b02 = b01 + (a01 - b01) * b12
    return e02 + b02, b02


# ---------------------------------------------------------------------------
# pairwise gain estimation
# ---------------------------------------------------------------------------


def _solve_gain_ls(o, op, w_rows):
    """Regularized least squares for (a, b) over the last axis (any leading
    batch dims): rows o_i = op_i a + (1 - op_i) b weighted by ``w_rows``,
    plus REG_W (a - 1) = 0 and REG_W b = 0. The 2x2 normal equations are
    solved by Cramer's rule."""
    a_col = op * w_rows
    b_col = (1.0 - op) * w_rows
    s_aa = torch.sum(a_col * a_col, -1) + REG_W**2
    s_ab = torch.sum(a_col * b_col, -1)
    s_bb = torch.sum(b_col * b_col, -1) + REG_W**2
    r_a = torch.sum(a_col * o * w_rows, -1) + REG_W**2 * 1.0
    r_b = torch.sum(b_col * o * w_rows, -1)
    det = s_aa * s_bb - s_ab * s_ab
    return (s_bb * r_a - s_ab * r_b) / det, (s_aa * r_b - s_ab * r_a) / det


def estimate_gains_ransac(
    o: torch.Tensor,  # (..., J) intensities in the history frame
    op: torch.Tensor,  # (..., J) intensities in the current frame
    valid: torch.Tensor,  # (..., J)
    idx: torch.Tensor,  # (..., H, 4) sample indices of H hypotheses
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(a, b, n_inliers) per leading index; fewer than 4 valid pairs give
    (1, 0, 0). The winner is the first hypothesis with the most votes."""
    j = o.shape[-1]
    lead = idx.shape[:-1]
    idx = idx.long()
    so = torch.gather(o[..., None, :].expand(lead + (j,)), -1, idx)
    sop = torch.gather(op[..., None, :].expand(lead + (j,)), -1, idx)
    a_h, b_h = _solve_gain_ls(so, sop, torch.ones_like(so))  # (..., H)
    resid = torch.abs(o[..., None, :] - (op[..., None, :] * (a_h - b_h)[..., None] + b_h[..., None]))
    inl = (resid < RANSAC_THR) & valid[..., None, :]  # (..., H, J)
    votes = torch.sum(inl, -1)
    best = torch.argmax(votes, -1, keepdim=True)
    inliers = torch.gather(inl, -2, best[..., None].expand(best.shape + (j,)))[..., 0, :]
    a, b = _solve_gain_ls(o, op, inliers.to(o.dtype))
    enough = torch.sum(valid, -1) >= 4
    n_inl = torch.where(enough, torch.gather(votes, -1, best)[..., 0], 0).to(torch.int32)
    return torch.where(enough, a, 1.0), torch.where(enough, b, 0.0), n_inl


# ---------------------------------------------------------------------------
# temporal state + per-frame processing
# ---------------------------------------------------------------------------


class PhotoDims(NamedTuple):
    n_history: int = 4  # history frames matched per call
    n_obs: int = 100  # intensity pairs per history frame (budget)
    window: int = 15  # params_PT ring length


@dataclass(frozen=True)
class PhotoState:
    params_pt: torch.Tensor  # (window, 2) origin-referenced (a, b) per frame
    frame_ptr: torch.Tensor  # () int32: index of the newest frame in the ring
    n_frames: torch.Tensor  # () int32

    @staticmethod
    def zero(dims: PhotoDims, dtype=torch.float32, device=None) -> "PhotoState":
        device = resolve(device)
        pt = torch.zeros((dims.window, 2), dtype=dtype, device=device)
        pt[:, 0] = 1.0
        return PhotoState(
            params_pt=pt,
            frame_ptr=torch.zeros((), dtype=torch.int32, device=device),
            n_frames=torch.ones((), dtype=torch.int32, device=device),
        )

    def current(self) -> torch.Tensor:
        """(2,) gains (a, b) of the newest frame (a gather on the device)."""
        return self.params_pt.index_select(0, self.frame_ptr.reshape(1))[0]


def process_frame(
    dims: PhotoDims,
    state: PhotoState,
    intensity_history: torch.Tensor,  # (Fh, J) intensities in history frames
    intensity_current: torch.Tensor,  # (Fh, J) same features in the current frame
    pair_valid: torch.Tensor,  # (Fh, J)
    frame_offsets: torch.Tensor,  # (Fh,) int32: how many frames back (>= 1)
    idx: torch.Tensor,  # (Fh, H, 4) RANSAC sample indices per history
    epsilon_gap: float = 0.02,
    epsilon_base: float = 0.005,
) -> Tuple[PhotoState, torch.Tensor, torch.Tensor]:
    """One ``ProcessCurrentFrame``: this frame's origin-referenced gains
    from every history at once. Returns (state, a, b)."""
    w = dims.window
    a_prev, b_prev = state.current().unbind(-1)
    a_hc, b_hc, support = estimate_gains_ransac(intensity_history, intensity_current, pair_valid, idx)
    hist_idx = torch.remainder(state.frame_ptr - (frame_offsets - 1), w)
    ph = state.params_pt[hist_idx.long()]  # (Fh, 2)
    a_oc, b_oc = chain_gains(ph[:, 0], ph[:, 1], a_hc, b_hc)
    a_pc, b_pc = relative_gains(a_prev, b_prev, a_oc, b_oc)
    ok = (torch.sum(pair_valid, -1) > 4) & (frame_offsets <= state.n_frames)
    support = torch.where(ok, support, 0)
    w_count = torch.sum(support)
    denom = torch.clamp(w_count, min=1)
    a_pc = torch.where(w_count >= 5, torch.sum(a_pc * support) / denom, 1.0)
    b_pc = torch.where(w_count >= 5, torch.sum(b_pc * support) / denom, 0.0)

    # drift anchoring
    delta = (1.0 - (a_pc - b_pc)) * epsilon_gap
    a_pc = a_pc + delta
    b_pc = b_pc - delta
    a_pc = a_pc - (a_pc - 1.0) * epsilon_base
    b_pc = b_pc - b_pc * epsilon_base

    a_oc, b_oc = chain_gains(a_prev, b_prev, a_pc, b_pc)
    ptr = torch.remainder(state.frame_ptr + 1, w).to(torch.int32)
    at_ptr = (torch.arange(w, device=ptr.device) == ptr)[:, None]
    params_pt = torch.where(at_ptr, torch.stack([a_oc, b_oc])[None], state.params_pt)
    state = PhotoState(params_pt=params_pt, frame_ptr=ptr,
                       n_frames=torch.clamp(state.n_frames + 1, max=w).to(torch.int32))
    return state, a_oc, b_oc


# ---------------------------------------------------------------------------
# spatial calibration
# ---------------------------------------------------------------------------


def solve_cell_offsets(n_cells: int, sid_hist, sid_cur, vec_b, valid):
    """The per-cell offsets x (n_cells,) of the +1/-1 difference system
    (rows x[sid_cur] - x[sid_hist] = b where ``valid``) by dense normal
    equations with a 1e-6 Tikhonov term, and which cells the rows touch
    (``seen``, (n_cells,) bool).

    ``A^T A`` is a graph Laplacian with one constant direction per connected
    component of the touched cells, fixed only by the 1e-6 term. The normal
    equations are formed and solved in float64 whatever ``vec_b``'s dtype:
    in float32 the term is lost beside a row count of 32 or more (32 +
    1e-6 rounds to 32), the integer Laplacian is singular, and the card's
    LU met an exact zero pivot (a map of NaN). A float32 solve is the
    float64 one rounded; the reference solves in its working dtype. The
    solve skips the host-side error check (``solve_ex``)."""
    dtype, dev = vec_b.dtype, vec_b.device
    wrow = valid.to(torch.float64)
    cells = torch.arange(n_cells, device=dev)
    onehot_p = (sid_cur[:, None] == cells).to(torch.float64)
    onehot_m = (sid_hist[:, None] == cells).to(torch.float64)
    a_mat = (onehot_p - onehot_m) * wrow[:, None]  # (S, n)
    ata = a_mat.T @ a_mat + 1e-6 * torch.eye(n_cells, dtype=torch.float64, device=dev)
    atb = a_mat.T @ (vec_b.to(torch.float64) * wrow)
    x = torch.linalg.solve_ex(ata, atb[:, None])[0][:, 0].to(dtype)
    return x, (onehot_p.sum(0) + onehot_m.sum(0)) > 0


def gpr_smooth(x, seen, n_cells_x: int, n_cells_y: int, gp_length_scale: float = 1.5,
               gp_sigma_f: float = 0.1, gp_sigma_n: float = 0.01) -> torch.Tensor:
    """SE-kernel Gaussian-process regression of the cell values ``x`` over
    the cell grid, trained on the ``seen`` cells (the others masked by a
    noise of 1e6), predicted at every cell. Returns (n_cells_y, n_cells_x)."""
    n = n_cells_x * n_cells_y
    dtype, dev = x.dtype, x.device
    cells = torch.arange(n, device=dev)
    pts = torch.stack([cells % n_cells_x, cells // n_cells_x], dim=1).to(dtype)  # (n, 2)
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
    k_full = gp_sigma_f**2 * torch.exp(-0.5 * d2 / gp_length_scale**2)
    noise = torch.full((n,), 1e6, dtype=dtype, device=dev).masked_fill(seen, gp_sigma_n**2)
    k_train = k_full + torch.diag(noise)
    alpha = torch.linalg.solve_ex(k_train, torch.where(seen, x, 0.0)[:, None])[0]
    return (k_full @ alpha)[:, 0].reshape(n_cells_y, n_cells_x)


def estimate_spatial_parameters(
    n_cells_x: int,
    n_cells_y: int,
    sid_hist: torch.Tensor,  # (S,) int32 cell ids
    sid_cur: torch.Tensor,  # (S,)
    vec_b: torch.Tensor,  # (S,) rhs
    valid: torch.Tensor,  # (S,)
    gp_length_scale: float = 1.5,
    gp_sigma_f: float = 0.1,
    gp_sigma_n: float = 0.01,
) -> torch.Tensor:
    """Per-cell offsets (:func:`solve_cell_offsets`) smoothed over the cell
    grid (:func:`gpr_smooth`). Returns (n_cells_y, n_cells_x)."""
    x, seen = solve_cell_offsets(n_cells_x * n_cells_y, sid_hist, sid_cur, vec_b, valid)
    return gpr_smooth(x, seen, n_cells_x, n_cells_y, gp_length_scale, gp_sigma_f, gp_sigma_n)


def expand_spatial(params_cells: torch.Tensor, h: int, w: int, div: int) -> torch.Tensor:
    """(cells_y, cells_x) -> (h, w) per-pixel map by nearest-cell replication."""
    return params_cells.repeat_interleave(div, 0).repeat_interleave(div, 1)[:h, :w]


# ---------------------------------------------------------------------------
# image correction
# ---------------------------------------------------------------------------


def _fold_lut(v: torch.Tensor) -> torch.Tensor:
    """Triangular LUT: i<128 -> 2i ; i==128 -> 255 ; i>128 -> 512-2i."""
    return torch.where(v < 128, 2 * v, torch.where(v == 128, 255, 512 - 2 * v))


def correct_image(img, a, b, params_ps=None, cyclic_lut: bool = False) -> torch.Tensor:
    """Gain-corrected image (the reference's ``getCorrectedImage``).

    The image is taken to float32 and scaled to [0, 1] in float32, as the
    reference does; the gains apply in the wider float type of the image
    and the gains, the map's subtraction in the wider of that and the map's
    (Python-float gains stay float32, as the reference's weak types do).
    ``cyclic_lut=True`` wraps the corrected
    intensity modulo 256 (truncation toward zero, then a floor modulo) and
    remaps it through the triangular fold LUT, uint8 out; the default clips
    to [0, 1] and returns float [0, 255]."""
    x = torch.as_tensor(img).to(torch.float32) / 255.0
    dt = functools.reduce(torch.promote_types,
                          [v.dtype for v in (a, b) if isinstance(v, torch.Tensor)], torch.float32)
    corr = x.to(dt) * (a - b) + b
    if params_ps is not None:
        corr = corr.to(torch.promote_types(dt, params_ps.dtype)) - params_ps
    if cyclic_lut:
        v = torch.remainder((corr * 255.0).to(torch.int32), 256)
        return _fold_lut(v).to(torch.uint8)
    return torch.clamp(corr, 0.0, 1.0) * 255.0
