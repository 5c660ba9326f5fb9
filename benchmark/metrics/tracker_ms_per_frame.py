"""Tracker layer (``vision/tracker.TrackerProgram``): device milliseconds of
the tracker per fleet frame, from the marks around each call in the window
(its one host read per frame included)."""


def read(run):
    ms = run.spans.get("tracker")
    return sum(ms) / run.window.frames if ms else None
