"""Per-stage wall-clock timing report (port of
``x_multi_agent_tpu.utils.timing``; the reference's TIMING flag as a
runtime switch).

Use as a context manager around host-level stages. With ``sync`` (a tensor
or a state container), leaving the stage waits for every CUDA device that
holds one of its tensors, so the time covers the device work. Enable with
``Timing.enabled = True``.
"""
from __future__ import annotations

import collections
import time
from typing import Dict

import torch

from .tree import leaves


class Timing:
    enabled: bool = False
    _acc: Dict[str, float] = collections.defaultdict(float)
    _cnt: Dict[str, int] = collections.defaultdict(int)

    def __init__(self, name: str, sync=None):
        self.name = name
        self.sync = sync

    def __enter__(self):
        if Timing.enabled:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if Timing.enabled:
            if self.sync is not None:
                devices = {x.device for x in leaves(self.sync) if isinstance(x, torch.Tensor)}
                for dev in devices:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            dt = time.perf_counter() - self.t0
            Timing._acc[self.name] += dt
            Timing._cnt[self.name] += 1
        return False

    @classmethod
    def report(cls) -> str:
        lines = ["stage                          total_ms   calls   ms/call"]
        for k in sorted(cls._acc):
            tot = cls._acc[k] * 1e3
            n = cls._cnt[k]
            lines.append(f"{k:30s} {tot:9.2f} {n:7d} {tot / max(n, 1):9.3f}")
        return "\n".join(lines)

    @classmethod
    def reset(cls):
        cls._acc.clear()
        cls._cnt.clear()
