"""The port's recorder: host spans, device stamps and counters where the
main path does its work, and the per-stage table of the reference's TIMING
flag (:class:`Timing`). Off by default; while off, every hook checks one
module-level flag and returns.

* **Host spans** (:func:`span`, :func:`frame`): name, parent, start and end
  on ``time.perf_counter_ns()``, and a frame identifier, that of the
  outermost open span (so every span of one fleet frame shares it). While a
  ``torch.profiler`` is active, each span also opens a ``record_function``
  range of its name, so the profiler's trace names the program's stages.
* **Device stamps** (:func:`stamp`, and a compiled program's graph bounds in
  ``utils/graph.py``): the kernel ``csrc/stamp.cu`` writes (stamp id, the
  device's ``%globaltimer`` in ns) into a ring in device memory. A graph
  captured while the recorder is on holds the stamps as kernel nodes; one
  captured while it is off holds none, and enabling the recorder later adds
  none. Nothing reads the ring until :func:`collect`. On CPU tensors a stamp
  is a host-clock record at the same place.
* **Counters** (:func:`count`): ``host_syncs`` (each device-to-host read of
  the main path) and ``detect_frames`` (tracker calls whose gate took the
  detection branch).

:func:`enable` turns the recorder on (before the programs capture their
graphs), :func:`start` drops what was recorded so far and calibrates the
device clock against the host's, :func:`collect` reads the ring once,
calibrates again, maps the stamps onto the host clock (the offset
interpolated linearly between the two calibrations), matches each graph's
device interval to the host ``launch`` span of its call (per graph, in
stream order), and attributes each device gap (one graph's last stamp to the
next graph's first) to the innermost host span open at its midpoint. A ring
that overflows counts the stamps it lost (``lost_stamps``); it never wraps.
"""
from __future__ import annotations

import collections
import math
import time
from bisect import bisect_right
from typing import Callable

import torch
from torch.autograd import profiler as _profiler

from .. import native

CAPACITY = 1 << 20  # ring entries (16 MiB per device): 20x a 51-s window's stamps
CALIBRATIONS = 256  # synchronized stamps per calibration (~10 ms); the narrowest is kept

STAMP = native.Kernel("stamp", source="x_multi_agent_torch/csrc/stamp.cu",
                      replaces="none: the recorder's device clock")

_ON = False  # the recorder's one switch
_clock = time.perf_counter_ns
_labels: list = []  # stamp id -> (kind, name): ("begin" | "end", graph) or ("stage", label)
_ids: dict = {}
# device index -> (ring (n, 2) int64, cursor (1,) int64), kept for the
# process's life: the graphs that stamp into a ring hold its address
_rings: dict = {}


class _Recording:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.spans = []  # [name, parent index, start ns, end ns, frame, detail]
        self.stack = []  # indices of the open spans
        self.host_stamps = []  # (stamp id, ns) of stamps on CPU tensors
        self.lost = 0  # host stamps past the capacity (a device ring's is its own)
        self.counters = collections.Counter()
        self.calibration = {}  # device index -> (offset ns, half width ns, device ns)


_rec = _Recording(CAPACITY)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "detail", "rec", "i", "range")

    def __init__(self, name: str, detail):
        self.name, self.detail = name, detail

    def __enter__(self):
        self.rec = rec = _rec
        parent = rec.stack[-1] if rec.stack else None
        self.i = len(rec.spans)
        root = self.i if parent is None else rec.spans[parent][4]
        rec.spans.append([self.name, parent, _clock(), None, root, self.detail])
        rec.stack.append(self.i)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec.spans[self.i][3] = _clock()
        self.rec.stack.pop()
        return False


def span(name: str, detail=None):
    """A host span ``with span(name):``; ``detail`` (e.g. the graph a
    ``launch`` replays) is kept beside it."""
    if not _ON:
        return _NULL
    return _Span(name, detail)


def frame():
    """The ``frame`` span, where no span is open (the outermost call)."""
    if not _ON or _rec.stack:
        return _NULL
    return _Span("frame", None)


def count(name: str) -> None:
    if not _ON:
        return
    _rec.counters[name] += 1


def _id(kind: str, name: str) -> int:
    key = (kind, name)
    i = _ids.get(key)
    if i is None:
        i = _ids[key] = len(_labels)
        _labels.append(key)
    return i


def _ring(device: torch.device):
    index = device.index if device.index is not None else torch.cuda.current_device()
    ring = _rings.get(index)
    if ring is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the recorder's ring is made by the eager run before a capture")
        ring = _rings[index] = (torch.zeros((_rec.capacity, 2), dtype=torch.int64, device=device),
                                torch.zeros((1,), dtype=torch.int64, device=device))
    return ring


def _put(i: int, device: torch.device) -> None:
    if device.type == "cuda":
        ring, cursor = _ring(device)
        STAMP.launch("xmat_stamp", ring.data_ptr(), cursor.data_ptr(), i, ring.shape[0])
    elif len(_rec.host_stamps) < _rec.capacity:
        _rec.host_stamps.append((i, _clock()))
    else:
        _rec.lost += 1


def stamp(label: str, like: torch.Tensor) -> None:
    """A stage stamp on the device of ``like``; a stage lasts until the next
    stamp of its graph."""
    if not _ON:
        return
    _put(_id("stage", label), like.device)


def bound(graph: str, end: bool, device: torch.device) -> None:
    """The first (``end`` False) or last stamp of a compiled program's graph."""
    if not _ON:
        return
    _put(_id("end" if end else "begin", graph), device)


# ---------------------------------------------------------------------------
# the device clock against the host's
# ---------------------------------------------------------------------------


def calibrate(sample: Callable, n: int = CALIBRATIONS) -> tuple:
    """(offset ns, half width ns, device ns) of the device clock against the
    host's from ``n`` samples ``(host before, device, host after)``: the
    narrowest, the device reading taken at the middle of its host interval."""
    h0, d, h1 = min((sample() for _ in range(n)), key=lambda s: s[2] - s[0])
    return (h0 + h1) // 2 - d, (h1 - h0 + 1) // 2, d


def _cuda_sample(device: torch.device) -> Callable:
    """One synchronized stamp between two host reads, into a ring of its own."""
    ring = torch.zeros((1, 2), dtype=torch.int64, device=device)
    cursor = torch.zeros((1,), dtype=torch.int64, device=device)

    def sample():
        cursor.zero_()
        torch.cuda.synchronize(device)
        h0 = _clock()
        STAMP.launch("xmat_stamp", ring.data_ptr(), cursor.data_ptr(), -1, 1)
        torch.cuda.synchronize(device)
        h1 = _clock()
        return h0, int(ring[0, 1]), h1

    sample()  # the first launch loads the library
    return sample


def to_host(t, first: tuple, last: tuple):
    """Device ns ``t`` on the host clock: the calibrations' offsets
    interpolated linearly in device time."""
    (o0, _, d0), (o1, _, d1) = first, last
    if d1 == d0:
        return t + o0
    return t + o0 + (o1 - o0) * (t - d0) / (d1 - d0)


# ---------------------------------------------------------------------------
# switching, and reading what was recorded
# ---------------------------------------------------------------------------


def enable(capacity: int = CAPACITY) -> None:
    """Turn the recorder on: the programs captured from now on hold device
    stamps. Starts a recording (:func:`start`). ``capacity``: the stamps a
    recording keeps (a card's ring keeps the capacity it was made with)."""
    global _ON, _rec
    _rec = _Recording(capacity)
    _ON = True
    start()


def disable() -> None:
    """Turn the recorder off; what it recorded stays for :func:`collect`."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def start() -> None:
    """Drop what was recorded so far (the device rings' cursors are reset on
    the current stream) and calibrate the current card's clock."""
    global _rec
    _rec = _Recording(_rec.capacity)
    for _, cursor in _rings.values():
        cursor.zero_()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
        _rec.calibration[dev.index] = calibrate(_cuda_sample(dev))


def _intervals(stamps: list) -> tuple:
    """Graph intervals from one stream's stamps ``(id, host ns)`` in stream
    order: [graph, begin, end, [(stage, ns)]], and the stamps outside any
    graph."""
    out, cur, loose = [], None, 0
    for i, t in stamps:
        kind, name = _labels[i]
        if kind == "begin":
            cur = [name, t, None, []]
        elif cur is None:
            loose += 1
        elif kind == "stage":
            cur[3].append((name, t))
        elif kind == "end" and name == cur[0]:
            cur[2] = t
            out.append(cur)
            cur = None
    return out, loose


NO_SPAN = "(no span)"


def _innermost(spans: list, starts: list, t) -> str:
    """The name of the innermost host span open at host time ``t``."""
    k = bisect_right(starts, t) - 1
    while k >= 0:
        name, parent, _, end, _, _ = spans[k]
        if end is None or end >= t:
            return name
        if parent is None:  # a closed outermost span: nothing before it is open
            return NO_SPAN
        k -= 1
    return NO_SPAN


def collect() -> dict:
    """What was recorded since :func:`start` (reads each device ring once;
    waits for the device). Times in ms on the host clock:

    ``frames`` (outermost ``frame`` spans), ``host_ms`` / ``host_calls`` per
    span name, ``counters``, ``stage_ms`` per stage label (from its stamp to
    the next stamp of its graph), ``graph_ms`` / ``graph_calls`` per graph
    (first to last stamp), ``busy_ms`` (their sum), ``gap_ms`` per innermost
    host span at a gap's middle (``NO_SPAN``: none open) and
    ``gap_total_ms``, ``lost_stamps``, ``loose_stamps`` (stage stamps outside
    a graph), ``unmatched`` (graph intervals without their ``launch`` span,
    and launches without an interval), ``clock`` (per card: the offset, the
    larger calibration's half width, the drift between the two calibrations
    and the seconds between them, and the smallest positive step between two
    consecutive stamps), and the raw ``spans`` and ``intervals`` ([graph,
    frame, begin, end, [(stage, ns)]], host ns)."""
    rec = _rec
    lost = rec.lost
    streams, clock = [list(rec.host_stamps)], {}
    for index, (ring, cursor) in _rings.items():
        dev = ring.device
        torch.cuda.synchronize(dev)
        n = int(cursor[0])
        lost += max(0, n - ring.shape[0])
        raw = ring[:min(n, ring.shape[0])].tolist()
        last = calibrate(_cuda_sample(dev))
        first = rec.calibration.get(index, last)
        ts = [t for _, t in raw]
        steps = [b - a for a, b in zip(ts, ts[1:]) if b > a]
        clock[index] = {"offset_ns": first[0], "uncertainty_ns": max(first[1], last[1]),
                        "drift_ns": last[0] - first[0], "over_s": (last[2] - first[2]) / 1e9,
                        "min_step_ns": min(steps) if steps else None}
        streams.append([(i, to_host(t, first, last)) for i, t in raw])
    spans = rec.spans
    host_ms, host_calls = collections.defaultdict(float), collections.Counter()
    launches = collections.defaultdict(list)
    for name, _, t0, t1, root, detail in spans:
        if t1 is None:
            continue
        host_ms[name] += (t1 - t0) / 1e6
        host_calls[name] += 1
        if name == "launch":
            launches[detail].append(root)
    starts = [s[2] for s in spans]
    stage_ms, graph_ms = collections.defaultdict(float), collections.defaultdict(float)
    graph_calls, gap_ms = collections.Counter(), collections.defaultdict(float)
    intervals, loose, matched = [], 0, collections.Counter()
    for stamps in streams:
        found, n_loose = _intervals(stamps)
        loose += n_loose
        prev_end = None
        for g, t0, t1, stages in found:
            k = matched[g]
            matched[g] += 1
            root = launches[g][k] if k < len(launches[g]) else None
            intervals.append([g, root, t0, t1, stages])
            graph_ms[g] += (t1 - t0) / 1e6
            graph_calls[g] += 1
            ends = [t for _, t in stages[1:]] + [t1]
            for (label, t), e in zip(stages, ends):
                stage_ms[label] += (e - t) / 1e6
            if prev_end is not None and t0 > prev_end:
                gap_ms[_innermost(spans, starts, (prev_end + t0) / 2)] += (t0 - prev_end) / 1e6
            prev_end = t1
    unmatched = sum(abs(len(launches[g]) - matched[g]) for g in set(launches) | set(matched))
    return {
        "frames": sum(1 for s in spans if s[0] == "frame" and s[1] is None),
        "host_ms": dict(host_ms), "host_calls": dict(host_calls),
        "counters": dict(rec.counters),
        "stage_ms": dict(stage_ms), "graph_ms": dict(graph_ms), "graph_calls": dict(graph_calls),
        "busy_ms": math.fsum(graph_ms.values()),
        "gap_ms": dict(gap_ms), "gap_total_ms": math.fsum(gap_ms.values()),
        "lost_stamps": lost, "loose_stamps": loose, "unmatched": unmatched,
        "clock": clock, "spans": [list(s) for s in spans], "intervals": intervals,
    }


class Timing:
    """The reference's TIMING flag: ``with Timing(name):`` is a host span of
    the recorder (recorded while it is on), and :meth:`report` the operator's
    per-stage table of what it recorded (host spans, then device stages)."""

    def __init__(self, name: str):
        self._span = span(name)

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        return self._span.__exit__(*exc)

    @staticmethod
    def report() -> str:
        got = collect()
        rows = [(k, got["host_ms"][k], got["host_calls"][k]) for k in sorted(got["host_ms"])]
        calls = collections.Counter(label for iv in got["intervals"] for label, _ in iv[4])
        rows += [(f"{k} (device)", got["stage_ms"][k], calls[k]) for k in sorted(got["stage_ms"])]
        lines = ["stage                          total_ms   calls   ms/call"]
        for k, tot, n in rows:
            lines.append(f"{k:30s} {tot:9.2f} {n:7d} {tot / max(n, 1):9.3f}")
        return "\n".join(lines)

    @staticmethod
    def reset() -> None:
        start()
