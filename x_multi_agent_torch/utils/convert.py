"""State conversion between the JAX reference package and the port.

:func:`from_numpy` turns one of the reference's state objects whose leaves
the caller has already mapped to numpy arrays into the port's class of the
same name: a ``FilterState`` (with its ``VisionState``), ``CoreState``,
``TrackSlots``, ``FrameTracks``, ``TrackerState``, ``Matches``, ``AgentPayload``,
``KeyframeDB``, ``MatchStore``, ``KfMeta``, ``HarvestedWork`` or a
``Vocabulary`` (its words; its integer fields stay integers). It reads
fields by name and never imports JAX. :func:`to_numpy` goes back: the
port's dataclass -> a dict of numpy arrays keyed by field name (nested for
nested states), so both packages can start from, and be compared on, one
state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _registry():
    from ..ekf.state import CoreState, FilterState, VisionState
    from ..parallel.collab import KfMeta
    from ..parallel.match_store import HarvestedWork, MatchStore
    from ..parallel.payload import AgentPayload
    from ..place_recognition.database import KeyframeDB
    from ..place_recognition.vocabulary import Vocabulary
    from ..vio.track_manager import FrameTracks, Matches, TrackSlots
    from ..vision.tracker import TrackerState

    return {
        c.__name__: c
        for c in (CoreState, FilterState, VisionState, TrackSlots, TrackerState, Matches,
                  AgentPayload, KeyframeDB, MatchStore, KfMeta, HarvestedWork, Vocabulary,
                  FrameTracks)
    }


def _field_names(cls):
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(cls._fields)  # NamedTuple


def from_numpy(obj, device, dtype=torch.float32):
    """Reference state object with numpy leaves -> the port's class.
    Floating leaves take ``dtype``; integer and boolean leaves keep theirs;
    Python scalars stay as they are."""
    reg = _registry()
    name = type(obj).__name__
    if name not in reg:
        raise TypeError(f"no port counterpart for {name}")
    cls = reg[name]
    vals = {}
    for fname in _field_names(cls):
        leaf = getattr(obj, fname)
        if type(leaf).__name__ in reg:
            vals[fname] = from_numpy(leaf, device, dtype)
            continue
        if isinstance(leaf, (int, float, bool)):
            vals[fname] = leaf
            continue
        arr = np.asarray(leaf)
        t = torch.from_numpy(np.array(arr, copy=True)).to(device)
        vals[fname] = t.to(dtype) if arr.dtype.kind == "f" else t
    return cls(**vals)


def to_numpy(obj):
    """The port's dataclass (or a tensor) -> numpy (dicts keyed by field)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    raise TypeError(f"cannot convert {type(obj).__name__}")
