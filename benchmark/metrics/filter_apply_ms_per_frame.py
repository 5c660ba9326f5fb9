"""Filter layer (``vio/pipeline.visual_update``, ``ekf.process_update_aux_impl``):
device milliseconds per fleet frame applying the rows (whitening, the Kalman
update, the corrections, feature initialisation and the tail's
re-propagation), from each ``apply`` stamp to the next stamp or the graph's end."""
from .recorded import stage


def read(run):
    return stage(run, "apply")
