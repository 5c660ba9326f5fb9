"""State trees (tensors in NamedTuples, dataclasses and tuples) as the
harness needs them: cloned, flattened by field path, rebuilt in the
reference's classes, and parameter sets built from a configuration file."""
from __future__ import annotations

import dataclasses
import importlib

import torch


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(type(obj), "_fields")


def map_tree(fn, obj):
    """``obj`` with ``fn`` applied to every tensor leaf (other leaves kept)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if _is_namedtuple(obj):
        return type(obj)(*(map_tree(fn, x) for x in obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: map_tree(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tree(fn, x) for x in obj)
    if isinstance(obj, dict):
        return {k: map_tree(fn, x) for k, x in obj.items()}
    return obj


def clone(obj):
    return map_tree(lambda t: t.clone(), obj)


def leaves(obj, prefix: str = "") -> dict:
    """{field path: tensor} of every tensor leaf."""
    out = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif _is_namedtuple(obj):
        for name, x in zip(obj._fields, obj):
            out.update(leaves(x, f"{prefix}.{name}"))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            out.update(leaves(getattr(obj, f.name), f"{prefix}.{f.name}"))
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            out.update(leaves(x, f"{prefix}[{i}]"))
    return out


def convert(obj, src_pkg: str, dst_pkg: str):
    """``obj`` rebuilt in the classes of ``dst_pkg`` that mirror those of
    ``src_pkg`` (same module path below the package, same class name and
    fields); tensors are shared, not copied."""
    if isinstance(obj, torch.Tensor):
        return obj

    def twin(o):
        mod = type(o).__module__
        if not mod.startswith(src_pkg + "."):
            raise TypeError(f"{type(o).__qualname__} is not a class of {src_pkg}")
        return getattr(importlib.import_module(dst_pkg + mod[len(src_pkg):]),
                       type(o).__qualname__)

    if _is_namedtuple(obj):
        fields = [convert(x, src_pkg, dst_pkg) for x in obj]
        return twin(obj)(*fields) if type(obj).__module__.startswith(src_pkg) else \
            type(obj)(*fields)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return twin(obj)(**{f.name: convert(getattr(obj, f.name), src_pkg, dst_pkg)
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(convert(x, src_pkg, dst_pkg) for x in obj)
    return obj


def build(cls, values: dict):
    """A parameter set of NamedTuple class ``cls`` from a configuration
    file's dict: nested dicts become the nested parameter sets of the
    field's default, lists become tuples; a key that ``cls`` lacks raises."""
    unknown = set(values) - set(cls._fields)
    if unknown:
        raise KeyError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    kwargs = {}
    for name, v in values.items():
        default = cls._field_defaults.get(name)
        if isinstance(v, dict):
            kwargs[name] = build(type(default), v)
        elif isinstance(v, list):
            kwargs[name] = tuple(v)
        else:
            kwargs[name] = v
    return cls(**kwargs)
