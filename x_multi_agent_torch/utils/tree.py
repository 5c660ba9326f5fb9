"""Helpers for batched state containers (dataclasses / NamedTuples of tensors).

The JAX reference vmaps per-agent functions and writes per-agent branches as
``lax.cond``, which under ``vmap`` runs both branches and selects. The port
keeps the agent axis explicit, so the same select is :func:`where` over two
whole state containers.
"""
from __future__ import annotations

import dataclasses

import torch


def _bcast(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))


def where(cond: torch.Tensor, a, b):
    """Per-agent select: leaves of ``a`` where ``cond`` (A,) else ``b``.

    Works on tensors, dataclasses, NamedTuples and tuples (recursively)."""
    if isinstance(a, torch.Tensor):
        return torch.where(_bcast(cond, a), a, b)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(
            a,
            **{
                f.name: where(cond, getattr(a, f.name), getattr(b, f.name))
                for f in dataclasses.fields(a)
            },
        )
    if isinstance(a, tuple):
        vals = [where(cond, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    if a is None:
        return None
    raise TypeError(f"cannot select over {type(a).__name__}")


def map_leaves(fn, obj):
    """Apply ``fn`` to every tensor leaf of a state container."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj,
            **{f.name: map_leaves(fn, getattr(obj, f.name))
               for f in dataclasses.fields(obj)},
        )
    if isinstance(obj, tuple):
        vals = [map_leaves(fn, x) for x in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


_SCALARS = (bool, int, float)


def leaves(obj) -> list:
    """The leaves of a state container, depth first in field order: tensors
    and Python scalars (a ring pointer, a frame count); ``None`` is an empty
    subtree."""
    if isinstance(obj, (torch.Tensor,) + _SCALARS):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj) for x in leaves(getattr(obj, f.name))]
    if isinstance(obj, tuple):
        return [x for v in obj for x in leaves(v)]
    if obj is None:
        return []
    raise TypeError(f"not a state container: {type(obj).__name__}")


def unflatten(template, values):
    """Rebuild ``template``'s structure from ``values`` in :func:`leaves`
    order."""
    it = iter(values)

    def build(obj):
        if isinstance(obj, (torch.Tensor,) + _SCALARS):
            return next(it)
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(
                obj, **{f.name: build(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
        if isinstance(obj, tuple):
            vals = [build(v) for v in obj]
            return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
        return obj

    return build(template)


def cat(objs):
    """Concatenate same-structured state containers along the agent axis."""
    first = objs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(objs, dim=0)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(
            first, **{f.name: cat([getattr(o, f.name) for o in objs])
                      for f in dataclasses.fields(first)},
        )
    if isinstance(first, tuple):
        vals = [cat(list(xs)) for xs in zip(*objs)]
        return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)
    raise TypeError(f"cannot concatenate {type(first).__name__}")


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along axis 1: ``out[a, ...] = x[a, idx[a, ...]]``.

    x: (A, N, *tail), idx: (A, *s) integer -> (A, *s, *tail). The per-agent
    counterpart of ``x[idx]`` inside a vmapped function."""
    a = x.shape[0]
    ar = torch.arange(a, device=x.device).reshape((a,) + (1,) * (idx.dim() - 1))
    return x[ar, idx.long()]


def put(x: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Batched scatter along axis 1 (out-of-place): ``out[a, idx[a, j]] =
    rows[a, j]``. Indices must be distinct per agent except where the caller
    sends rows to a dump slot it slices off afterwards."""
    out = x.clone()
    a = x.shape[0]
    ar = torch.arange(a, device=x.device).reshape((a,) + (1,) * (idx.dim() - 1))
    out[ar, idx.long()] = rows.to(x.dtype)
    return out


def scatter_dump(base: torch.Tensor, tgt: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``concat([base, dump_row]).at[tgt].set(rows)[:n]`` per agent: rows whose
    target is ``n`` (= base.shape[1]) land in a sacrificial row."""
    n = base.shape[1]
    padded = torch.cat([base, torch.zeros_like(base[:, :1])], dim=1)
    return put(padded, tgt, rows)[:, :n]


def topk_stable(key: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, lower index first
    among equal values (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
