"""State conversion between the JAX reference package and the port.

:func:`from_numpy` turns one of the reference's state objects — a
``FilterState`` (with its ``VisionState``), ``CoreState``, ``TrackSlots``,
``TrackerState``, ``Matches`` or ``AgentPayload`` whose leaves the caller has already mapped
to numpy arrays — into the port's dataclass of the same name. It reads
fields by name and never imports JAX. :func:`to_numpy` goes back: the port's
dataclass -> a dict of numpy arrays keyed by field name (nested for nested
states), so both packages can start from, and be compared on, one state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _registry():
    from ..ekf.state import CoreState, FilterState, VisionState
    from ..parallel.payload import AgentPayload
    from ..vio.track_manager import Matches, TrackSlots
    from ..vision.tracker import TrackerState

    return {
        c.__name__: c
        for c in (CoreState, FilterState, VisionState, TrackSlots, TrackerState, Matches,
                  AgentPayload)
    }


def from_numpy(obj, device, dtype=torch.float32):
    """Reference state object with numpy leaves -> the port's dataclass.
    Floating leaves take ``dtype``; integer and boolean leaves keep theirs."""
    reg = _registry()
    name = type(obj).__name__
    if name not in reg:
        raise TypeError(f"no port counterpart for {name}")
    cls = reg[name]
    vals = {}
    for f in dataclasses.fields(cls):
        leaf = getattr(obj, f.name)
        if type(leaf).__name__ in reg:
            vals[f.name] = from_numpy(leaf, device, dtype)
            continue
        arr = np.asarray(leaf)
        t = torch.from_numpy(np.array(arr, copy=True)).to(device)
        vals[f.name] = t.to(dtype) if arr.dtype.kind == "f" else t
    return cls(**vals)


def to_numpy(obj):
    """The port's dataclass (or a tensor) -> numpy (dicts keyed by field)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    raise TypeError(f"cannot convert {type(obj).__name__}")
