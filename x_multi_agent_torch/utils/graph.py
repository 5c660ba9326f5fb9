"""Compiled fixed-shape programs: the port's counterpart of ``jax.jit``.

:func:`compiled` wraps a function of state trees (dataclasses, NamedTuples
and tuples of tensors) into a program that runs as one CUDA graph per call on
the card. The first call for each capture key (the tree structure, each
tensor leaf's shape, dtype and device, and the value of every other leaf)
stages the arguments into static buffers, runs the function once eagerly on
a side stream (which fills ``utils.const.constant``, the keyed sampler's
counter cache and cuBLAS's handles, and gives that call's result), then
captures it into a ``torch.cuda.CUDAGraph``. Every later call copies its
arguments into the buffers and replays the graph: no host work per op.

The state is the carry of the reference's ``lax.scan``: the first
``n_carry`` arguments are carried, and the function's first ``n_carry``
results (same structure) are copied into their buffers by the graph's last
ops. A call returns those buffers, valid until the next call of the same
program; passed back, they are not copied in (a fresh tree is, with
``copy_``). The other results are the graph's own outputs, overwritten by
the next call. Each call's other arguments are copied into buffers of their
own.

Several programs of one owner may share their carried state (a
:class:`Carry`): each carried argument is staged once per spec for all of
them, so a state one program returns is passed to the next with no copy (the
``VIO`` facade's IMU, tracker, update and photometric programs share its
filter state, track slots and collaboration state this way).

On CPU tensors (the tests) the function runs on the same staged buffers with
the same carry rule, with no graph: that is the plain path. On the card a
capture or replay that fails raises, naming the program; nothing falls back
to the eager function. ``linalg.require_fp32_matmul`` runs on every call.

A hand-written kernel's wrapper counts its launches in Python
(``native.Kernel``), which a replay does not run: each graph reads, from its
kernel nodes' function names, the launches of each hand-written kernel it
holds (``<name>_kernel``), checks them against those its capture counted, and
adds them on every replay, so the counts stay those of the kernels that ran.
Where libcuda cannot name a node's function, the capture's count is added
and ``Graphs.kernels_read`` is false. The eager first run counts as it
launched.

The functions must be capture-safe: no host read of a device value
(``.item()``, ``bool(t)``), no tensor built from host data, no operation
whose output shape depends on the data (``nonzero``, boolean-mask indexing),
no linear algebra that checks its errors on the host (use the ``_ex``
forms). ``tests/test_torch_graph.py`` holds the main path to that on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import gc
import time
from typing import Callable

import torch

from .. import native
from ..ops import linalg
from . import tree


def spec(obj):
    """The capture key of an argument tree: its structure, each tensor
    leaf's shape, dtype and device, each other leaf's value."""
    if isinstance(obj, torch.Tensor):
        return (torch.Tensor, tuple(obj.shape), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj):
        return (type(obj), tuple(spec(getattr(obj, f.name)) for f in dataclasses.fields(obj)))
    if isinstance(obj, tuple):
        return (type(obj), tuple(spec(x) for x in obj))
    return (type(obj), obj)


def _tensors(obj) -> list:
    return [x for x in tree.leaves(obj) if isinstance(x, torch.Tensor)]


def device_of(obj) -> torch.device:
    """The one device of an argument tree's tensors."""
    devs = {x.device for x in _tensors(obj)}
    if len(devs) != 1:
        raise ValueError(f"a compiled program takes tensors on one device, got {devs}")
    return devs.pop()


def stage(obj):
    """Static buffers for an argument tree: a copy of every tensor leaf."""
    return tree.map_leaves(lambda x: x.clone(), obj)


def copy_in(bufs, obj) -> None:
    """Copy ``obj``'s tensor leaves into ``bufs`` (same spec), skipping each
    leaf that is its buffer."""
    for b, x in zip(_tensors(bufs), _tensors(obj)):
        if x is not b:
            b.copy_(x)


def _aliases(x: torch.Tensor, bufs: list) -> bool:
    ptr = x.untyped_storage().data_ptr()
    return any(ptr == b.untyped_storage().data_ptr() for b in bufs)


def write_carry(bufs, outs, name: str) -> None:
    """Copy the tree ``outs`` into the carry buffers ``bufs`` (same spec).
    A result that shares memory with a carry buffer other than its own is
    copied first, so no copy reads a buffer that another has written."""
    if spec(bufs) != spec(outs):
        raise ValueError(f"{name}: the carried results do not match the carried arguments")
    b_leaves, o_leaves = _tensors(bufs), _tensors(outs)
    o_leaves = [o if o is b or not _aliases(o, b_leaves) else o.clone()
                for b, o in zip(b_leaves, o_leaves)]
    for b, o in zip(b_leaves, o_leaves):
        if o is not b:
            b.copy_(o)


def _graph_nodes(graph):
    """(the kernel, memcpy and memset nodes of a captured graph: the device
    events one replay gives a trace; its kernel nodes per function name),
    from libcuda's graph API; None for what libcuda cannot say."""
    try:
        cu = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None, None
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        return None, None
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        return None, None
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None)
    func_name, kernel_name = getattr(cu, "cuFuncGetName", None), getattr(cu, "cuKernelGetName", None)
    names = collections.Counter() if get_params and func_name and kernel_name else None
    params = (ctypes.c_void_p * 16)()  # CUDA_KERNEL_NODE_PARAMS_v2: func [0], kern [7]
    name = ctypes.c_char_p()
    kind = ctypes.c_int(0)
    events = 0
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            return None, None
        events += kind.value in (0, 1, 2)  # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
        if kind.value != 0 or names is None:
            continue
        if get_params(ctypes.c_void_p(node), params) != 0:
            names = None
            continue
        func, kern = params[0], params[7]
        err = (func_name(ctypes.byref(name), ctypes.c_void_p(func)) if func
               else kernel_name(ctypes.byref(name), ctypes.c_void_p(kern)))
        if err != 0 or name.value is None:
            names = None
            continue
        names[name.value.decode()] += 1
    return events, names


class Graphs:
    """The graphs of one program: one memory pool and one side stream, with
    what their captures cost (for the card's report)."""

    def __init__(self, name: str):
        self.name = name
        self.pool = None
        self.stream = None
        self.captured = 0  # graphs captured on the card
        self.capture_s = 0.0  # wall seconds of those captures (the eager first runs not included)
        self.pool_bytes = 0  # torch.cuda.memory_reserved() growth over the captures: the pool
        self.replayed_nodes = 0  # device events the replays so far gave (None: not known)
        self.kernels_read = True  # every graph's kernel launches read from its nodes

    def graph(self, label: str, fn: Callable):
        return _Graph(self, f"{self.name}:{label}", fn)


class _Graph:
    """``fn()``, which reads only buffers that outlive the graph, as one
    CUDA graph: captured on the first call (whose result is that of an
    eager run), replayed after. On the CPU, ``fn()``."""

    def __init__(self, owner: Graphs, name: str, fn: Callable):
        self.owner, self.name, self.fn = owner, name, fn
        self.graph = None
        self.out = None
        self.launches = None  # per-kernel launches one replay makes
        self.nodes = None

    def __call__(self, device: torch.device):
        if device.type != "cuda":
            return self.fn()
        if self.graph is None:
            return self._capture()
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: CUDA graph replay failed: {e}") from e
        for k, n in zip(native.KERNELS, self.launches):
            k.launches += n
        own = self.owner
        own.replayed_nodes = (None if own.replayed_nodes is None or self.nodes is None
                              else own.replayed_nodes + self.nodes)
        return self.out

    def _capture(self):
        own = self.owner
        if own.pool is None:
            own.pool = torch.cuda.graph_pool_handle()
            own.stream = torch.cuda.Stream()
        cur, side = torch.cuda.current_stream(), own.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self.fn()  # the eager run: this call's result, its launches counted
        cur.wait_stream(side)
        torch.cuda.synchronize()
        # a program dropped in a reference cycle frees its graphs when the
        # collector runs, and a graph destroyed during a capture breaks it:
        # collect now, and not during the capture
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        before = [k.launches for k in native.KERNELS]
        g = torch.cuda.CUDAGraph(keep_graph=True)  # kept to read its nodes
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g, pool=own.pool, stream=side):
                out = self.fn()
            g.instantiate()
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: CUDA graph capture failed (a host read of a device value, a "
                f"tensor from host data, a data-dependent shape or a host-checked solve in the "
                f"program?): {e}") from e
        finally:
            if collecting:
                gc.enable()
            after = [k.launches for k in native.KERNELS]
            for k, n in zip(native.KERNELS, before):
                k.launches = n  # nothing ran during the capture
        counted = [a - b for a, b in zip(after, before)]
        self.nodes, names = _graph_nodes(g)
        if names is None:
            own.kernels_read, self.launches = False, counted
        else:
            self.launches = [sum(c for fn, c in names.items() if f"{k.name}_kernel" in fn)
                             for k in native.KERNELS]
            if self.launches != counted:
                raise RuntimeError(
                    f"{self.name}: the graph holds {self.launches} launches of "
                    f"{[k.name for k in native.KERNELS]}, its capture counted {counted}")
        torch.cuda.synchronize()
        own.captured += 1
        own.capture_s += time.perf_counter() - t0
        own.pool_bytes += torch.cuda.memory_reserved() - reserved
        for o, f in zip(_tensors(out), _tensors(first)):
            o.copy_(f)
        self.graph, self.out = g, out
        return out


class Carry:
    """Carry buffers that several programs of one owner share: one staged
    tree per spec. A program stages each carried argument here, so what one
    program carries is the buffer another reads and writes, and a state
    passed back from any of them is not copied (a fresh tree is copied in).
    The programs sharing it must carry no two arguments of one spec in one
    call."""

    def __init__(self):
        self._bufs = {}

    def stage(self, obj):
        """The shared buffers of ``obj``'s spec, holding ``obj``."""
        key = spec(obj)
        bufs = self._bufs.get(key)
        if bufs is None:
            bufs = self._bufs[key] = stage(obj)
        else:
            copy_in(bufs, obj)
        return bufs


class Programs:
    """Per capture key, the static buffers of a program's arguments and what
    ``build(bufs, label)`` made on them (its graphs): the keying and staging
    of :class:`Compiled` and ``vision.tracker.TrackerProgram``. ``captures``
    counts the capture keys seen (graphs captured on the card, staged
    buffer sets on the CPU). With a :class:`Carry`, the first ``n_carry``
    arguments are staged in it."""

    def __init__(self, name: str, carry: Carry = None):
        self.name = name
        self.graphs = Graphs(name)
        self.carry = carry
        self._built = {}
        self.captures = 0

    def _stage(self, args: tuple, n_carry: int) -> tuple:
        if self.carry is None or not n_carry:
            return stage(args)
        specs = [spec(x) for x in args[:n_carry]]
        if len(set(specs)) != len(specs):
            raise ValueError(f"{self.name}: two carried arguments of one spec share a Carry")
        return tuple(self.carry.stage(x) if i < n_carry else stage(x)
                     for i, x in enumerate(args))

    def get(self, args: tuple, build: Callable, static=(), n_carry: int = 0):
        """(device, buffers, built) for ``args``, keyed on their spec and
        ``static``: staged and built on the key's first call, copied into
        the buffers after (``linalg.require_fp32_matmul`` every call)."""
        dev = device_of(args)
        linalg.require_fp32_matmul(dev, self.name)
        key = (spec(args), static)
        hit = self._built.get(key)
        if hit is None:
            bufs = self._stage(args, n_carry)
            hit = self._built[key] = (bufs, build(bufs, f"{len(self._built)}"))
            self.captures += 1
        else:
            copy_in(hit[0], args)
        return dev, hit[0], hit[1]


class Compiled(Programs):
    """A function of state trees as a compiled program (module docstring).
    ``static`` values of a call (hashable; e.g. a sampler the function reads
    from its closure) are part of its capture key."""

    def __init__(self, fn: Callable, name: str, n_carry: int = 0, carry: Carry = None):
        super().__init__(name, carry)
        self.fn, self.n_carry = fn, n_carry

    def __call__(self, *args, static=()):
        dev, bufs, graph = self.get(
            args, lambda b, label: self.graphs.graph(label, lambda: self._body(b)), static,
            self.n_carry)
        return tuple(bufs[:self.n_carry]) + tuple(graph(dev))

    def _body(self, bufs):
        outs = self.fn(*bufs)
        n = self.n_carry
        if n:
            write_carry(tuple(bufs[:n]), tuple(outs[:n]), self.name)
        return tuple(outs[n:])


def compiled(fn: Callable, name: str, n_carry: int = 0, carry: Carry = None) -> Compiled:
    """``fn`` as a compiled program whose first ``n_carry`` arguments and
    results are the carried state, staged in ``carry`` when given (module
    docstring)."""
    return Compiled(fn, name, n_carry, carry)
