"""IMU strapdown propagation (port of ``x_multi_agent_tpu.ekf.propagator``).

Mean: 4th-order quaternion integrator (Trawny eqs. 130-131) + trapezoidal
v/p integration. Covariance: closed-form 15x15 discrete transition F_d, and
Q_d by Van Loan (expm of the 30x30 block matrix by a Taylor series of the
SAME order and scaling as the reference: order 4, one squaring). Per-step
(F_d, Q_d) are compounded and applied to the big covariance once.

Every function is batched over leading dims (agents, ring slots).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops import lie
from ..utils.const import constant
from .state import CoreState


class ImuNoise(NamedTuple):
    """Continuous-time IMU noise densities."""

    n_w: float = 0.0083  # gyro noise [rad/s/sqrt(Hz)]
    n_bw: float = 0.00083  # gyro bias random walk
    n_a: float = 0.0013  # accel noise [m/s^2/sqrt(Hz)]
    n_ba: float = 0.00013  # accel bias random walk


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# mean propagation
# ---------------------------------------------------------------------------


def quaternion_integrator(e_w_0: torch.Tensor, e_w_1: torch.Tensor, dt) -> torch.Tensor:
    """(..., 4, 4) quaternion integration matrices (Trawny (130)-(131)):
    4th-order Taylor of expm(0.5*Omega(w_mean)*dt) plus the first-order
    non-commutativity correction. dt broadcasts as (...)."""
    omega_0 = lie.omega_matrix(e_w_0)
    omega_1 = lie.omega_matrix(e_w_1)
    omega_mean = lie.omega_matrix(0.5 * (e_w_0 + e_w_1))
    dt = torch.as_tensor(dt, dtype=e_w_0.dtype, device=e_w_0.device)[..., None, None]
    a = omega_mean * (0.5 * dt)
    eye = _eye(4, a)
    mat_exp = eye + a @ (eye + a @ (eye / 2 + a @ (eye / 6 + a / 24)))
    return mat_exp + (1.0 / 48.0) * (omega_1 @ omega_0 - omega_0 @ omega_1) * dt * dt


def propagate_mean(core_0: CoreState, time_1, seq_1, w_m_1, a_m_1, g) -> CoreState:
    """One strapdown step per agent (biases constant between updates)."""
    dt = time_1 - core_0.time
    e_w_0 = core_0.w_m - core_0.b_w
    e_a_0 = core_0.a_m - core_0.b_a
    e_w_1 = w_m_1 - core_0.b_w
    e_a_1 = a_m_1 - core_0.b_a

    dq_mat = quaternion_integrator(e_w_0, e_w_1, dt)
    q_1 = lie.quat_normalize((dq_mat @ core_0.q[..., None])[..., 0])
    dv = 0.5 * (
        (lie.quat_to_rot(q_1) @ e_a_1[..., None])[..., 0]
        + (lie.quat_to_rot(core_0.q) @ e_a_0[..., None])[..., 0]
    )
    v_1 = core_0.v + (dv + g) * dt[..., None]
    p_1 = core_0.p + 0.5 * (v_1 + core_0.v) * dt[..., None]
    return dataclasses.replace(
        core_0,
        time=time_1.to(core_0.p.dtype),
        seq=seq_1.to(torch.int32),
        p=p_1, v=v_1, q=q_1, w_m=w_m_1, a_m=a_m_1,
    )


def prefix_products(mats: torch.Tensor) -> torch.Tensor:
    """All prefix products P_k = M_k ... M_0 of (..., L, n, n) matrices in
    ceil(log2 L) rounds (Hillis-Steele scan along axis -3)."""
    l, n = mats.shape[-3], mats.shape[-1]
    eye = _eye(n, mats)
    p = mats
    shift = 1
    while shift < l:
        pad = eye.expand(mats.shape[:-3] + (shift, n, n))
        prev = torch.cat([pad, p[..., : l - shift, :, :]], dim=-3)
        p = torch.matmul(p, prev)
        shift *= 2
    return p


def propagate_mean_batch(
    start: CoreState,  # leading dims (A,)
    times: torch.Tensor,  # (A, L)
    seqs: torch.Tensor,  # (A, L)
    w_ms: torch.Tensor,  # (A, L, 3)
    a_ms: torch.Tensor,  # (A, L, 3)
    valid: torch.Tensor,  # (A, L) masked steps are exact identities
    g: torch.Tensor,  # (3,)
) -> CoreState:
    """Parallel strapdown over a batch of IMU samples (equivalent to scanning
    :func:`propagate_mean`): quaternion prefix products + v/p cumsums.
    Returns a CoreState with leading dims (A, L)."""
    dtype = start.p.dtype
    l = times.shape[-1]
    t_prev = torch.cat([start.time[..., None], times[..., :-1]], dim=-1)
    dt = torch.where(valid, (times - t_prev).to(dtype), torch.zeros((), dtype=dtype, device=times.device))
    w_prev = torch.cat([start.w_m[..., None, :], w_ms[..., :-1, :]], dim=-2)
    a_prev = torch.cat([start.a_m[..., None, :], a_ms[..., :-1, :]], dim=-2)
    e_w0 = w_prev - start.b_w[..., None, :]
    e_w1 = w_ms - start.b_w[..., None, :]
    e_a0 = a_prev - start.b_a[..., None, :]
    e_a1 = a_ms - start.b_a[..., None, :]

    d_mats = quaternion_integrator(e_w0, e_w1, dt)
    p_mats = prefix_products(d_mats)
    q_all = lie.quat_normalize((p_mats @ start.q[..., None, :, None])[..., 0])
    q_prev = torch.cat([start.q[..., None, :], q_all[..., :-1, :]], dim=-2)

    r_all = lie.quat_to_rot(q_all)
    r_prev = lie.quat_to_rot(q_prev)
    dv = 0.5 * (
        torch.einsum("...kij,...kj->...ki", r_all, e_a1)
        + torch.einsum("...kij,...kj->...ki", r_prev, e_a0)
    )
    v_all = start.v[..., None, :] + torch.cumsum((dv + g) * dt[..., None], dim=-2)
    v_prev = torch.cat([start.v[..., None, :], v_all[..., :-1, :]], dim=-2)
    p_all = start.p[..., None, :] + torch.cumsum(0.5 * (v_all + v_prev) * dt[..., None], dim=-2)
    shape3 = v_all.shape
    return CoreState(
        time=torch.where(valid, times.to(dtype), t_prev.to(dtype)),
        seq=seqs.to(torch.int32),
        p=p_all,
        v=v_all,
        q=q_all,
        b_w=start.b_w[..., None, :].expand(shape3),
        b_a=start.b_a[..., None, :].expand(shape3),
        w_m=w_ms,
        a_m=a_ms,
    )


# ---------------------------------------------------------------------------
# discrete error-state transition + process noise
# ---------------------------------------------------------------------------


def _blocks(rows):
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def discrete_state_transition(dt, e_w, e_a, q_1) -> torch.Tensor:
    """Closed-form (..., 15, 15) discrete transition."""
    w_x = lie.skew(e_w)
    a_x = lie.skew(e_a)
    eye3 = _eye(3, q_1).expand(w_x.shape)
    c_q = lie.quat_to_rot(q_1)
    dt = dt[..., None, None]

    dt_2_f2 = dt * dt * 0.5
    dt_3_f3 = dt_2_f2 * dt / 3.0
    dt_4_f4 = dt_3_f3 * dt * 0.25
    dt_5_f5 = dt_4_f4 * dt * 0.2

    w_x2 = w_x @ w_x
    c_q_a_x = c_q @ a_x
    blk_p_th = c_q_a_x @ (-dt_2_f2 * eye3 + dt_3_f3 * w_x - dt_4_f4 * w_x2)
    blk_p_bw = c_q_a_x @ (dt_3_f3 * eye3 - dt_4_f4 * w_x + dt_5_f5 * w_x2)
    blk_v_bw = -blk_p_th
    blk_th_th = eye3 - dt * w_x + dt_2_f2 * w_x2
    blk_th_bw = -dt * eye3 + dt_2_f2 * w_x - dt_3_f3 * w_x2
    blk_v_th = c_q_a_x @ blk_th_bw

    zero3 = torch.zeros_like(eye3)
    return _blocks([
        [eye3, dt * eye3, blk_p_th, blk_p_bw, -c_q * dt_2_f2],
        [zero3, eye3, blk_v_th, blk_v_bw, -c_q * dt],
        [zero3, zero3, blk_th_th, blk_th_bw, zero3],
        [zero3, zero3, zero3, eye3, zero3],
        [zero3, zero3, zero3, zero3, eye3],
    ])


def continuous_matrices(e_w, e_a, q_1, noise: ImuNoise):
    """Continuous-time (F_c, G Qc G^T) of the 15-dim error model."""
    c_q = lie.quat_to_rot(q_1)
    eye3 = _eye(3, q_1).expand(c_q.shape)
    zero3 = torch.zeros_like(eye3)
    f_c = _blocks([
        [zero3, eye3, zero3, zero3, zero3],
        [zero3, zero3, -c_q @ lie.skew(e_a), zero3, -c_q],
        [zero3, zero3, -lie.skew(e_w), -eye3, zero3],
        [zero3, zero3, zero3, zero3, zero3],
        [zero3, zero3, zero3, zero3, zero3],
    ])
    diag = constant(
        (0.0,) * 3 + (noise.n_a**2,) * 3 + (noise.n_w**2,) * 3
        + (noise.n_bw**2,) * 3 + (noise.n_ba**2,) * 3,
        q_1.dtype, q_1.device,
    )
    return f_c, torch.diag(diag).expand(f_c.shape)


def _expm_taylor(a: torch.Tensor, order: int = 8, scaling: int = 3) -> torch.Tensor:
    """Matrix exponential by scaling-and-squaring with a Horner Taylor series."""
    eye = _eye(a.shape[-1], a)
    x = a / (2.0**scaling)
    acc = eye + x / order
    for k in range(order - 1, 0, -1):
        acc = eye + (x / k) @ acc
    for _ in range(scaling):
        acc = acc @ acc
    return acc


def discrete_process_noise(dt, q_1, e_w, e_a, noise: ImuNoise) -> torch.Tensor:
    """Q_d by Van Loan (order-4 Taylor, one squaring, as the reference)."""
    f_c, gqg = continuous_matrices(e_w, e_a, q_1, noise)
    zeros = torch.zeros_like(f_c)
    vl = torch.cat(
        [torch.cat([-f_c, gqg], dim=-1), torch.cat([zeros, f_c.transpose(-1, -2)], dim=-1)],
        dim=-2,
    )
    e = _expm_taylor(vl * dt[..., None, None], order=4, scaling=1)
    phi_t = e[..., 15:30, 15:30]  # = Phi^T
    q_d = phi_t.transpose(-1, -2) @ e[..., 0:15, 15:30]
    return 0.5 * (q_d + q_d.transpose(-1, -2))


# ---------------------------------------------------------------------------
# covariance application
# ---------------------------------------------------------------------------


def step_transition(core_0: CoreState, core_1: CoreState, noise: ImuNoise):
    """(F_d, Q_d) for the step core_0 -> core_1 (linearized at core_1)."""
    dt = core_1.time - core_0.time
    e_w = core_1.w_m - core_1.b_w
    e_a = core_1.a_m - core_1.b_a
    f_d = discrete_state_transition(dt, e_w, e_a, core_1.q)
    q_d = discrete_process_noise(dt, core_1.q, e_w, e_a, noise)
    return f_d, q_d


def compound_transitions(f_d_steps: torch.Tensor, q_d_steps: torch.Tensor):
    """Compound per-step (F, Q) (..., L, 15, 15) into (Phi, Q_acc):
    (F2, Q2) ∘ (F1, Q1) = (F2 F1, F2 Q1 F2^T + Q2), as a pairwise tree over
    L padded to a power of two with identity steps."""
    l = f_d_steps.shape[-3]
    lp = 1 << (l - 1).bit_length()
    if lp != l:
        lead = f_d_steps.shape[:-3]
        pad_f = _eye(15, f_d_steps).expand(lead + (lp - l, 15, 15))
        pad_q = torch.zeros(lead + (lp - l, 15, 15), dtype=q_d_steps.dtype, device=q_d_steps.device)
        f_d_steps = torch.cat([f_d_steps, pad_f], dim=-3)
        q_d_steps = torch.cat([q_d_steps, pad_q], dim=-3)
    f, q = f_d_steps, q_d_steps
    n = lp
    while n > 1:
        fa, fb = f[..., 0::2, :, :], f[..., 1::2, :, :]
        qa, qb = q[..., 0::2, :, :], q[..., 1::2, :, :]
        f = torch.matmul(fb, fa)
        q = torch.matmul(fb, torch.matmul(qa, fb.transpose(-1, -2))) + qb
        n //= 2
    return f[..., 0, :, :], q[..., 0, :, :]


def propagate_covariance(cov: torch.Tensor, phi: torch.Tensor, q_acc: torch.Tensor):
    """Apply a compounded core transition to the (..., D, D) covariance:
    only the 15-row/col core strips move (lower strip computed as P_vi F^T,
    like the reference)."""
    top = phi @ cov[..., 0:15, :]
    cov = torch.cat([top, cov[..., 15:, :]], dim=-2)
    left = cov[..., :, 0:15] @ phi.transpose(-1, -2)
    cov = torch.cat([left, cov[..., :, 15:]], dim=-1)
    core = cov[..., 0:15, 0:15] + q_acc
    return torch.cat(
        [torch.cat([core, cov[..., 0:15, 15:]], dim=-1), cov[..., 15:, :]], dim=-2
    )
