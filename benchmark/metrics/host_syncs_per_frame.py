"""Compiled-programs layer: the main path's device-to-host reads per fleet
frame (the tracker's detection gate), from the program's ``host_syncs`` counter."""
from .recorded import per_frame


def read(run):
    return per_frame(run, lambda p: float(p["counters"].get("host_syncs", 0)))
