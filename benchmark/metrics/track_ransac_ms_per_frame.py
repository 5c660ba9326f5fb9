"""Tracker layer (``vision/tracker._track_core``): device milliseconds per
fleet frame of RANSAC (the keyed draws and ``ransac_inliers``), from the
``ransac`` stamp to the ``matches`` stamp in the tracker's first graph."""
from .recorded import stage


def read(run):
    return stage(run, "ransac")
