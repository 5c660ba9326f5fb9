"""Collaboration layer (``parallel/collab.request_response_round``): device
milliseconds of one REQUEST_COMM round, the mean over the window's rounds,
from the marks around each call."""


def read(run):
    ms = run.spans.get("round")
    return sum(ms) / len(ms) if ms else None
