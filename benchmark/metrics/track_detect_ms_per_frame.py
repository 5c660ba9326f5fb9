"""Tracker layer (``vision/tracker.TrackerProgram``): device milliseconds per
fleet frame of the graph after the gate, whole: detection (FAST, kernel K1,
and the slot update) or the keep branch, first to last stamp."""
from .recorded import per_frame


def read(run):
    def ms(p):
        got = [v for g, v in p["graph_ms"].items() if g.endswith((":detect", ":keep"))]
        return sum(got) if got else None

    return per_frame(run, ms, device=True)
