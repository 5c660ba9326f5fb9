"""Checkpoint / resume of the full system state (port of
``x_multi_agent_tpu.utils.checkpoint``).

Every state of the port (``FilterState``, ``TrackSlots``, the tracker state,
the keyframe DB, a facade's photometric state) is a container of tensors and
Python scalars, so a checkpoint is a flat dump of its leaves, in the order of
:func:`..utils.tree.leaves`, restored against a structural template.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .tree import leaves, unflatten


def save(path: str, obj: Any) -> None:
    """Write ``obj``'s leaves to the ``.npz`` file ``path`` (compressed)."""
    arrays = {}
    for i, x in enumerate(leaves(obj)):
        arrays[f"leaf_{i}"] = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    np.savez_compressed(path, **arrays)


def load(path: str, template: Any) -> Any:
    """Restore a checkpoint into ``template``'s structure: each tensor leaf
    takes the template leaf's dtype and device, each Python scalar its
    type. A leaf whose shape differs from the template's raises."""
    data = np.load(path)
    restored = []
    for i, t in enumerate(leaves(template)):
        arr = data[f"leaf_{i}"]
        shape = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
        if arr.shape != shape:
            raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != template {shape}")
        if isinstance(t, torch.Tensor):
            restored.append(torch.from_numpy(arr).to(dtype=t.dtype, device=t.device))
        else:
            restored.append(type(t)(arr.item()))
    return unflatten(template, restored)
