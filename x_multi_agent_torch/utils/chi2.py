"""Chi-square quantile gates (port of ``x_multi_agent_tpu.utils.chi2``).

The dof is a per-track tensor bounded by a static maximum, so the quantiles
are a dense table computed on the host with scipy and gathered per track.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.stats import chi2 as _chi2


@functools.lru_cache(maxsize=None)
def _table_np(confidence: float, max_dof: int) -> np.ndarray:
    dof = np.arange(max_dof + 1)
    t = _chi2.ppf(confidence, np.maximum(dof, 1))
    t[0] = 0.0  # dof 0: gate everything out
    t.setflags(write=False)
    return t


def chi2_quantile_table(confidence: float, max_dof: int, dtype, device) -> torch.Tensor:
    """(max_dof+1,) table; index with a dof tensor."""
    return torch.as_tensor(_table_np(confidence, max_dof).copy(), dtype=dtype, device=device)


def chi2_threshold(confidence: float, dof: int, max_dof: int) -> float:
    """The table's quantile at a static ``dof`` (a Python float, so a gate
    with a fixed dof needs no table on the device)."""
    return float(_table_np(confidence, max_dof)[min(max(dof, 0), max_dof)])


def chi2_gate(gamma: torch.Tensor, dof: torch.Tensor, confidence: float, max_dof: int):
    """True where gamma passes (is below) the chi2 quantile at ``dof``;
    dof is clipped into [0, max_dof] and dof <= 0 always fails."""
    table = chi2_quantile_table(confidence, max_dof, gamma.dtype, gamma.device)
    d = torch.clamp(dof, 0, max_dof).long()
    return (gamma < table[d]) & (dof > 0)
