"""The traced segment of a ``--trace 1`` run: fleet frames after the window,
run twice from one state: first counting each frame's live features (K2's
work) on the device, then under ``torch.profiler`` with nothing added,
reduced to what the per-layer readers and the result line need.

Read from the tracer's raw events (building its event tree takes seconds
for an eager round's ~10^5 events): the device's busy seconds (the union of
its operations' intervals), the host's kernel-launch and graph-launch calls,
each device operation's seconds by name, the idle gaps between device
operations by the innermost host operation open at the gap's middle, and
each hand-written kernel's device time per launch. Where the tracer kept
fewer device events than the host launched kernels plus the replayed graphs
hold, it dropped some, and ``dropped`` says so."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from .window import IN_FLIGHT

KERNEL_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


def _union_s(intervals) -> float:
    busy, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e9


def _top(totals: dict, n: int = 10) -> list:
    return [[name, s] for name, s in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _frames(fleet, clock, first: int, n_frames: int, live=None) -> None:
    """Frames ``first``.. as the window runs them (``IN_FLIGHT`` frames
    queued); with ``live`` a list, each frame's live features are counted
    on the device before it."""
    ends = []
    for k in range(first, first + n_frames):
        if len(ends) >= IN_FLIGHT:
            clock.wait(ends[-IN_FLIGHT])
        if live is not None:
            live.append(fleet.live_features())
        fleet.frame(k)
        ends.append(clock.mark())
    clock.sync()


def segment(fleet, clock, first: int, n_frames: int, kernels) -> dict:
    """``n_frames`` fleet frames from ``first`` under the profiler, on the
    image input after a first pass from the same state that counts their
    live features. ``kernels`` are the program's hand-written kernel
    counters (objects with ``name`` and ``launches``)."""
    from torch.profiler import ProfilerActivity, profile

    live = []
    if fleet.image:
        saved, rounds = fleet.state(), list(fleet.rounds)
        _frames(fleet, clock, first, n_frames, live)
        live = [int(x) for x in live]
        fleet.restore(saved)
        fleet.rounds = rounds
        del saved
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if clock.cuda else [])
    nodes0 = [g.replayed_nodes for g in fleet.graphs]
    launches0 = {k.name: k.launches for k in kernels}
    clock.sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _frames(fleet, clock, first, n_frames)
        wall = time.perf_counter() - t0
    nodes = [g.replayed_nodes for g in fleet.graphs]
    graph_nodes = (None if None in nodes0 + nodes
                   else sum(b - a for a, b in zip(nodes0, nodes)))
    dev, host, n_launch, n_graph = [], [], 0, 0
    cuda_type = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda_type:
            dev.append((e.start_ns(), e.end_ns(), name))
            continue
        n_launch += name in KERNEL_LAUNCH
        n_graph += name in GRAPH_LAUNCH
        host.append((e.start_ns(), e.end_ns(), name))
    op_s = defaultdict(float)
    kernel_ms = defaultdict(list)
    for a, b, name in dev:
        op_s[name] += (b - a) / 1e9
        for k in kernels:
            if f"{k.name}_kernel" in name:
                kernel_ms[k.name].append((b - a) / 1e6)
    gaps = defaultdict(float)
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    end = None
    for a, b, _ in dev:
        if end is not None and a > end:
            mid = (a + end) // 2
            i = bisect.bisect_right(starts, mid)
            open_ops = [h for h in host[max(0, i - 2000):i] if h[1] >= mid]
            name = min(open_ops, key=lambda h: h[1] - h[0])[2] if open_ops else "(no host op)"
            gaps[name] += (a - end) / 1e9
        end = b if end is None else max(end, b)
    expected = n_launch + (graph_nodes or 0)
    return {
        "frames": n_frames,
        "window_s": wall,
        "busy_s": _union_s((a, b) for a, b, _ in dev),
        "device_events": len(dev),
        "launch_calls": n_launch,
        "graph_launches": n_graph,
        "dropped": graph_nodes is None or len(dev) < expected,
        "kernel_ms": dict(kernel_ms),
        "kernel_launches": {k.name: k.launches - launches0[k.name] for k in kernels},
        "live_features": live,
        "device_ops": _top(op_s),
        "idle_gaps": _top(gaps),
    }
