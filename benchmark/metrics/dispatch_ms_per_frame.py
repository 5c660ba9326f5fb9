"""Compiled-programs layer (``utils/graph.py``): host milliseconds per fleet
frame in the program's ``dispatch`` spans (capture key, the fp32 check,
staging the arguments into the graphs' buffers) and ``launch`` spans (the
graph replays), from its recorder."""
from .recorded import per_frame


def read(run):
    return per_frame(run, lambda p: p["host_ms"].get("dispatch", 0.0) + p["host_ms"].get("launch", 0.0))
