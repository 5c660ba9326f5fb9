"""Filter layer (``vio/pipeline.visual_update``): device milliseconds per fleet
frame building the update rows (track classification, state management,
GN triangulation, the MSCKF, MSCKF-SLAM and SLAM Jacobians), from each ``rows``
stamp to the next ``apply`` stamp in the filter's graph."""
from .recorded import stage


def read(run):
    return stage(run, "rows")
