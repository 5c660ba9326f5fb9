"""Filter layer (``ekf/``, ``vio/pipeline.py`` through
``parallel/mesh.agent_step_fn``): device milliseconds of the filter step per
fleet frame, from the marks around each call in the window."""


def read(run):
    ms = run.spans.get("filter")
    return sum(ms) / run.window.frames if ms else None
