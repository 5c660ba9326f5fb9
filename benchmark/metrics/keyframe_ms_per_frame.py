"""Collaboration layer (``parallel/collab.maybe_add_keyframe``): device
milliseconds of the keyframe step per fleet frame, from the marks around each
call in the window."""


def read(run):
    ms = run.spans.get("keyframe")
    return sum(ms) / run.window.frames if ms else None
