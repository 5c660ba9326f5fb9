"""EKF orchestrator (port of ``x_multi_agent_tpu.ekf.ekf``).

The IMU path integrates only the core state into the ring buffer;
covariance propagation is deferred and compounded at update time (or the
anchor advances when an update lags more than ``max_update_lag`` samples).

Agents are an explicit leading axis. Where the reference branches per agent
(``lax.switch`` on the init status, ``lax.cond`` on the anchor lag and on
whether an update falls in the window), the port computes every branch and
selects per agent with :func:`..utils.tree.where`, as the reference does
under ``vmap``.

Init state machine: 0 = not initialized, 1 = standby (init state placed,
waiting for the first IMU sample), 2 = initialized.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..utils import tree
from ..utils.const import constant
from . import buffer as rb
from .propagator import (
    ImuNoise,
    compound_transitions,
    propagate_covariance,
    propagate_mean,
    propagate_mean_batch,
    step_transition,
)
from .state import CoreState, FilterState, StateDims, VisionState


class EkfParams(NamedTuple):
    """Static EKF configuration."""

    dims: StateDims = StateDims()
    g: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    imu_noise: ImuNoise = ImuNoise()
    a_m_max: float = 50.0  # accel spike threshold [m/s^2]
    time_margin: float = 0.02  # closestIdx tolerance [s]
    max_update_lag: int = 64  # static bound on IMU steps between updates

    def g_vec(self, like: torch.Tensor) -> torch.Tensor:
        return constant(tuple(self.g), like.dtype, like.device)


def _i32(x):
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def init_from_state(params: EkfParams, core: CoreState, vision: VisionState,
                    cov: torch.Tensor) -> FilterState:
    """Reset the buffer around an initial state (A agents); status -> standby."""
    a = core.p.shape[0]
    fs = FilterState.zero(params.dims, a, dtype=core.p.dtype, device=core.p.device)
    zero = torch.zeros((a,), dtype=torch.int32, device=core.p.device)
    return dataclasses.replace(
        fs,
        buffer=rb.set_slot(fs.buffer, zero, core),
        head=zero,
        size=zero + 1,
        anchor_buf_idx=zero,
        cov=cov,
        vision=vision,
        status=zero + 1,
    )


# ---------------------------------------------------------------------------
# IMU path
# ---------------------------------------------------------------------------


def _advance_anchor_one(params: EkfParams, fs: FilterState) -> FilterState:
    """Move the covariance anchor forward one buffer slot."""
    b = params.dims.buffer_size
    idx0 = fs.anchor_buf_idx
    idx1 = (idx0 + 1) % b
    f_d, q_d = step_transition(
        rb.get_slot(fs.buffer, idx0), rb.get_slot(fs.buffer, idx1), params.imu_noise
    )
    cov = propagate_covariance(fs.cov, f_d, q_d)
    return dataclasses.replace(fs, cov=cov, anchor_buf_idx=_i32(idx1))


def process_imu_impl(params: EkfParams, fs: FilterState, t, seq, w_m, a_m) -> FilterState:
    """One IMU sample per agent (t, seq (A,); w_m, a_m (A, 3)): spike
    filter, enqueue, propagate the core state."""
    dtype = fs.cov.dtype
    t = t.to(dtype)
    seq = seq.to(torch.int32)
    w_m = w_m.to(dtype)
    a_m = a_m.to(dtype)
    b = params.dims.buffer_size
    tail = rb.get_slot(fs.buffer, fs.head)

    spike = torch.linalg.norm(a_m, dim=-1) > params.a_m_max
    active = fs.status == 2
    a_use = torch.where((spike & active)[:, None], tail.a_m, a_m)
    seq_gap = active & (tail.seq >= 0) & (seq != tail.seq + 1)
    fs = dataclasses.replace(
        fs,
        n_spikes=_i32(fs.n_spikes + (spike & active).to(torch.int32)),
        n_seq_gaps=_i32(fs.n_seq_gaps + seq_gap.to(torch.int32)),
    )

    # standby: place the IMU data on the init state; -> initialized
    core = dataclasses.replace(tail, time=t, seq=seq, w_m=w_m, a_m=a_use)
    standby = dataclasses.replace(
        fs, buffer=rb.set_slot(fs.buffer, fs.head, core), status=torch.full_like(fs.status, 2)
    )

    # initialized: propagate, keep the anchor within max_update_lag of the head
    new_core = propagate_mean(tail, t, seq, w_m, a_use, params.g_vec(t))
    head1 = _i32((fs.head + 1) % b)
    prop = dataclasses.replace(
        fs,
        buffer=rb.set_slot(fs.buffer, head1, new_core),
        head=head1,
        size=_i32(torch.clamp(fs.size + 1, max=b)),
    )
    lag = rb.steps_between(prop.anchor_buf_idx, head1, b)
    prop = tree.where(lag >= params.max_update_lag, _advance_anchor_one(params, prop), prop)

    out = tree.where(fs.status == 1, standby, fs)
    return tree.where(fs.status == 2, prop, out)


def _advance_anchor_n(params: EkfParams, fs: FilterState, n_adv, max_n: int) -> FilterState:
    """Advance the covariance anchor ``n_adv`` (A,) (<= max_n) slots in one
    compounded covariance application."""
    b = params.dims.buffer_size
    ar = torch.arange(max_n, dtype=torch.int32, device=fs.cov.device)
    idx_prev = (fs.anchor_buf_idx[:, None] + ar) % b
    idx_next = (idx_prev + 1) % b
    f_all, q_all = step_transition(
        rb.get_slot(fs.buffer, idx_prev), rb.get_slot(fs.buffer, idx_next), params.imu_noise
    )
    mask = (ar < n_adv[:, None])[..., None, None]
    eye = torch.eye(15, dtype=fs.cov.dtype, device=fs.cov.device)
    f_all = torch.where(mask, f_all, eye)
    q_all = torch.where(mask, q_all, torch.zeros_like(q_all))
    phi, q_acc = compound_transitions(f_all, q_all)
    cov = propagate_covariance(fs.cov, phi, q_acc)
    return dataclasses.replace(fs, cov=cov, anchor_buf_idx=_i32((fs.anchor_buf_idx + n_adv) % b))


def process_imu_batch_impl(params: EkfParams, fs: FilterState, times, seqs, w_ms, a_ms):
    """Process a batch of IMU samples per agent (times, seqs (A, L); w_ms,
    a_ms (A, L, 3)). The first sample takes the single-step path (it owns
    the standby -> initialized transition); the rest run as one parallel
    program: last-non-spike accel hold (cummax), quaternion prefix products
    + v/p cumsums, one multi-row buffer write, one compounded anchor
    advance."""
    l = times.shape[1]
    fs = process_imu_impl(params, fs, times[:, 0], seqs[:, 0], w_ms[:, 0], a_ms[:, 0])
    if l == 1:
        return fs
    b = params.dims.buffer_size
    lt = l - 1
    dtype = fs.cov.dtype
    dev = fs.cov.device
    t_b, s_b = times[:, 1:].to(dtype), seqs[:, 1:].to(torch.int32)
    w_b, a_b = w_ms[:, 1:].to(dtype), a_ms[:, 1:].to(dtype)
    tail = rb.get_slot(fs.buffer, fs.head)

    # accel spike filter: hold the last accepted accel
    good = torch.linalg.norm(a_b, dim=-1) <= params.a_m_max
    idx = torch.arange(lt, dtype=torch.int64, device=dev).expand(good.shape)
    src = torch.cummax(torch.where(good, idx, torch.full_like(idx, -1)), dim=-1).values
    a_src = torch.gather(a_b, 1, torch.clamp(src, min=0)[..., None].expand(a_b.shape))
    a_use = torch.where((src >= 0)[..., None], a_src, tail.a_m[:, None, :])

    # failure-detection counters
    expected = torch.cat([tail.seq[:, None] + 1, s_b[:, :-1] + 1], dim=1)
    valid_prev = torch.cat(
        [(tail.seq >= 0)[:, None], torch.ones((s_b.shape[0], lt - 1), dtype=torch.bool, device=dev)],
        dim=1,
    )
    gaps = torch.sum((s_b != expected) & valid_prev, dim=1)
    batched = dataclasses.replace(
        fs,
        n_spikes=_i32(fs.n_spikes + torch.sum(~good, dim=1)),
        n_seq_gaps=_i32(fs.n_seq_gaps + gaps),
    )
    outs = propagate_mean_batch(
        tail, t_b, s_b, w_b, a_use, torch.ones_like(good), params.g_vec(t_b)
    )
    idxs = rb.ring_range(fs.head, lt, b)
    head1 = _i32((fs.head + lt) % b)
    batched = dataclasses.replace(
        batched,
        buffer=tree.put(fs.buffer, idxs, rb.pack_core(outs)),
        head=head1,
        size=_i32(torch.clamp(fs.size + lt, max=b)),
    )
    lag = rb.steps_between(batched.anchor_buf_idx, head1, b)
    n_adv = torch.clamp(lag - (params.max_update_lag - 1), min=0)
    batched = tree.where(n_adv > 0, _advance_anchor_n(params, batched, n_adv, lt), batched)
    return tree.where(fs.status == 2, batched, fs)


def process_imu_packed(params: EkfParams, fs: FilterState, x):
    """:func:`process_imu_impl` on one packed row per agent, ``x`` (A, 8)
    float64 = (t, seq, w_m, a_m): the host's sample in one upload (the
    ``VIO`` facade's compiled IMU program). Returns (fs, the tail core)."""
    fs = process_imu_impl(params, fs, x[:, 0], x[:, 1].to(torch.int32), x[:, 2:5], x[:, 5:8])
    return fs, tail_core(fs)


def process_imu_batch_packed(params: EkfParams, fs: FilterState, x):
    """:func:`process_imu_batch_impl` on packed rows, ``x`` (A, L, 8)
    float64 (as :func:`process_imu_packed`). Returns (fs, the tail core)."""
    fs = process_imu_batch_impl(params, fs, x[..., 0], x[..., 1].to(torch.int32), x[..., 2:5],
                                x[..., 5:8])
    return fs, tail_core(fs)


# ---------------------------------------------------------------------------
# update path
# ---------------------------------------------------------------------------


def _cov_at(params: EkfParams, fs: FilterState, idx) -> torch.Tensor:
    """Propagate the anchored covariance to buffer slot ``idx`` (A,)."""
    lag = params.max_update_lag
    b = params.dims.buffer_size
    steps = rb.steps_between(fs.anchor_buf_idx, idx, b)
    ar = torch.arange(lag, dtype=torch.int32, device=fs.cov.device)
    idx_prev = (fs.anchor_buf_idx[:, None] + ar) % b
    idx_next = (idx_prev + 1) % b
    f_all, q_all = step_transition(
        rb.get_slot(fs.buffer, idx_prev), rb.get_slot(fs.buffer, idx_next), params.imu_noise
    )
    mask = (ar < steps[:, None])[..., None, None]
    eye = torch.eye(15, dtype=fs.cov.dtype, device=fs.cov.device)
    f_all = torch.where(mask, f_all, eye)
    q_all = torch.where(mask, q_all, torch.zeros_like(q_all))
    phi, q_acc = compound_transitions(f_all, q_all)
    return propagate_covariance(fs.cov, phi, q_acc)


def _repropagate_tail(params: EkfParams, fs: FilterState, idx) -> FilterState:
    """Re-run mean propagation from the (corrected) state at ``idx`` (A,)
    to the buffer head."""
    lag = params.max_update_lag
    b = params.dims.buffer_size
    n_steps = rb.steps_between(idx, fs.head, b)
    idxs = rb.ring_range(idx, lag, b)
    samples = rb.get_slot(fs.buffer, idxs)
    step_mask = torch.arange(lag, device=idx.device) < n_steps[:, None]
    start = rb.get_slot(fs.buffer, idx)
    outs = propagate_mean_batch(
        start, samples.time, samples.seq, samples.w_m, samples.a_m, step_mask,
        params.g_vec(fs.cov),
    )
    buf = rb.set_rows(fs.buffer, idxs, rb.pack_core(outs), step_mask)
    return dataclasses.replace(fs, buffer=buf)


def update_window(params: EkfParams, fs: FilterState, meas_time):
    """Where a measurement at ``meas_time`` (A,) updates: its buffer slot
    ``idx`` (A,), whether it falls in the window (A,), and the anchored
    covariance propagated to ``idx``."""
    b = params.dims.buffer_size
    t_buf = rb.times(fs.buffer)
    idx = rb.closest_idx(t_buf, meas_time.to(fs.cov.dtype), params.time_margin)
    anchor_t = torch.gather(t_buf, 1, fs.anchor_buf_idx.long()[:, None])[:, 0]
    t_idx = torch.gather(t_buf, 1, torch.clamp(idx, min=0).long()[:, None])[:, 0]
    in_window = (
        (idx >= 0)
        & (fs.status == 2)
        & (rb.steps_between(fs.anchor_buf_idx, idx, b) < params.max_update_lag)
        & (t_idx >= anchor_t)
    )
    return idx, in_window, _cov_at(params, fs, idx)


def close_update(params: EkfParams, fs: FilterState, idx, in_window, core, vision,
                 cov) -> FilterState:
    """Write an update's result at slot ``idx`` (A,), anchor the covariance
    there and re-propagate the tail, for the agents ``in_window`` (A,)."""
    upd = dataclasses.replace(
        fs, buffer=rb.set_slot(fs.buffer, idx, core), cov=cov, vision=vision,
        anchor_buf_idx=idx,
    )
    upd = _repropagate_tail(params, upd, idx)
    return tree.where(in_window, upd, fs)


def process_update_aux_impl(params: EkfParams, fs: FilterState, meas_time, update_fn, aux):
    """Measurement update at ``meas_time`` (A,) threading an auxiliary state
    (e.g. track slots) through
    ``update_fn(core, vision, cov, aux) -> (core, vision, cov, aux)``.
    Returns (fs, aux, applied (A,)).

    Every agent runs ``update_fn``; agents whose measurement falls outside
    the window keep their state (per-agent select)."""
    idx, in_window, cov_meas = update_window(params, fs, meas_time)
    core = rb.get_slot(fs.buffer, idx)
    core1, vision1, cov1, aux1 = update_fn(core, fs.vision, cov_meas, aux)
    fs1 = close_update(params, fs, idx, in_window, core1, vision1, cov1)
    return fs1, tree.where(in_window, aux1, aux), in_window


def process_update(params: EkfParams, fs: FilterState, meas_time, update_fn):
    """:func:`process_update_aux_impl` without an auxiliary state:
    ``update_fn(core, vision, cov) -> (core, vision, cov)``. Returns
    (fs, applied (A,))."""
    fs, _, applied = process_update_aux_impl(
        params, fs, meas_time, lambda c, v, p, _: (*update_fn(c, v, p), None), None
    )
    return fs, applied



def tail_core(fs: FilterState) -> CoreState:
    """Newest core state per agent."""
    return rb.get_slot(fs.buffer, fs.head)
