"""Constant tensors built once per device.

``torch.tensor(values, device=cuda)`` copies from pageable host memory and
waits for the card's stream; a constant the filter needs on every call is
built once per (values, dtype, device) instead, so later calls copy nothing
and never wait. Callers must not write into the returned tensor.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)
