"""Tracker layer (``vision/tracker._track_segment``): device milliseconds per
fleet frame of the pyramids and LK (kernel K2), from the ``flow`` stamp to the
``ransac`` stamp in the tracker's first graph."""
from .recorded import stage


def read(run):
    return stage(run, "flow")
