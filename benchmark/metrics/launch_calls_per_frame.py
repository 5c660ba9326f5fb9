"""Compiled-programs layer (``utils/graph.py``): the host's kernel-launch
calls outside CUDA graphs per fleet frame in the traced segment, counted from
the profiler's host events (which it does not drop)."""


def read(run):
    t = run.trace
    return t["launch_calls"] / t["frames"] if t and t["frames"] else None
