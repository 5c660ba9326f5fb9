"""Tracker layer (``vision/tracker.TrackerProgram``): the share of tracker
calls whose gate took the detection graph, from the program's
``detect_frames`` counter over its ``tracker`` spans, in %."""
from .recorded import recording


def read(run):
    p = recording(run)
    calls = p and p["host_calls"].get("tracker")
    return 100.0 * p["counters"].get("detect_frames", 0) / calls if calls else None
