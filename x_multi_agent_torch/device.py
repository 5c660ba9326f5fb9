"""The port's default device: the CUDA card.

Every entry point and state constructor that takes ``device`` resolves it
here. ``None`` means the card; without one it raises rather than carry on
on the CPU. CPU callers (the parity tests) pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` -> ``cuda``, or raise when
    no CUDA card is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: the port runs on the card by default; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")
