"""IMU-rate ring buffer ops (port of ``x_multi_agent_tpu.ekf.buffer``).

The buffer is one packed (A, B, 24) tensor. Row layout:
[time, seq, p(3), v(3), q(4), b_w(3), b_a(3), w_m(3), a_m(3)]. Invalid slots
carry time < 0; ``seq`` is stored in the float row.
"""
from __future__ import annotations

import torch

from ..device import resolve
from ..utils.tree import put, take
from .state import CoreState

INVALID_IDX = -1

ROW_WIDTH = 24
_TIME, _SEQ = 0, 1
_P, _V, _Q, _BW, _BA, _WM, _AM = 2, 5, 8, 12, 15, 18, 21


def pack_core(core: CoreState) -> torch.Tensor:
    """CoreState with leading dims (...) -> (..., 24) rows (dtype of core.p)."""
    dtype = core.p.dtype
    return torch.cat(
        [
            core.time.to(dtype)[..., None],
            core.seq.to(dtype)[..., None],
            core.p, core.v, core.q, core.b_w, core.b_a, core.w_m, core.a_m,
        ],
        dim=-1,
    )



def unpack_core(row: torch.Tensor) -> CoreState:
    """(..., 24) rows -> CoreState with leading dims (...)."""
    return CoreState(
        time=row[..., _TIME],
        seq=row[..., _SEQ].to(torch.int32),
        p=row[..., _P:_V],
        v=row[..., _V:_Q],
        q=row[..., _Q:_BW],
        b_w=row[..., _BW:_BA],
        b_a=row[..., _BA:_WM],
        w_m=row[..., _WM:_AM],
        a_m=row[..., _AM:ROW_WIDTH],
    )


def empty_buffer(a: int, buffer_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    buf = torch.zeros((a, buffer_size, ROW_WIDTH), dtype=dtype, device=resolve(device))
    buf[..., _TIME] = -1.0  # invalid
    buf[..., _Q + 3] = 1.0  # identity quaternion (w)
    return buf


def times(buffer: torch.Tensor) -> torch.Tensor:
    return buffer[..., _TIME]


def get_slot(buffer: torch.Tensor, idx: torch.Tensor) -> CoreState:
    """Read ring slot(s) idx (A,) or (A, L) as a CoreState."""
    return unpack_core(take(buffer, idx))


def set_slot(buffer: torch.Tensor, idx: torch.Tensor, core: CoreState) -> torch.Tensor:
    """Write one ring slot per agent (idx (A,))."""
    return put(buffer, idx[:, None], pack_core(core)[:, None])


def set_rows(buffer: torch.Tensor, idxs: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor):
    """Masked multi-row write (idxs (A, L), rows (A, L, 24), mask (A, L))."""
    cur = take(buffer, idxs)
    return put(buffer, idxs, torch.where(mask[..., None], rows, cur))


def closest_idx(times_arr: torch.Tensor, t: torch.Tensor, time_margin: float) -> torch.Tensor:
    """Ring index (A,) of the valid state closest in time to ``t`` (A,), or
    -1 when the measurement is more than ``time_margin`` outside."""
    valid = times_arr >= 0
    dt = torch.where(valid, torch.abs(times_arr - t[:, None]),
                     torch.full_like(times_arr, float("inf")))
    idx = torch.argmin(dt, dim=-1)
    ok = torch.gather(dt, -1, idx[:, None])[:, 0] <= time_margin
    return torch.where(ok, idx.to(torch.int32), torch.full_like(idx, INVALID_IDX).to(torch.int32))


def ring_range(start: torch.Tensor, length: int, buffer_size: int) -> torch.Tensor:
    """Indices (A, length) of the ring slots after ``start`` (A,)."""
    ar = torch.arange(length, dtype=torch.int32, device=start.device)
    return (start[:, None] + 1 + ar) % buffer_size


def steps_between(from_idx, to_idx, buffer_size: int):
    """Number of ring steps from ``from_idx`` forward to ``to_idx``."""
    return (to_idx - from_idx) % buffer_size
