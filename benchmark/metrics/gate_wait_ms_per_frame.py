"""Tracker layer (``vision/tracker.TrackerProgram``): host milliseconds per
fleet frame in the detection gate's read (``gate`` span), which waits for the
device to finish the tracker's first graph."""
from .recorded import per_frame


def read(run):
    return per_frame(run, lambda p: p["host_ms"].get("gate"))
