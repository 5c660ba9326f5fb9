"""Compiled-programs layer (``utils/graph.py``): device milliseconds per fleet
frame from one graph's last stamp to the next graph's first: the device's idle
time plus the eager staging copies and launches outside the graphs, from the
program's recorder (``gap_ms`` names the host span open at each gap's middle)."""
from .recorded import per_frame


def read(run):
    return per_frame(run, lambda p: p["gap_total_ms"], device=True)
