"""What the program's own recorder (``x_multi_agent_torch/utils/timing.py``)
gave a run: ``run.program``, its ``collect()`` over the window
(``harness/recorder.py``). The readers of the recorder's spans, stamps and
counters return None where a run has none (a program without the recorder,
or a harness that did not pass it), and a device reading also where the
ring lost stamps or a graph's interval was not matched to its launch."""


def recording(run):
    p = getattr(run, "program", None)
    return p if p and p.get("frames") else None


def per_frame(run, value, device: bool = False):
    """``value(recording)`` over the window's fleet frames; None where
    ``value`` gives None."""
    p = recording(run)
    if p is None or device and (p["lost_stamps"] or p["unmatched"] or not p["graph_calls"]):
        return None
    v = value(p)
    return None if v is None else v / p["frames"]


def stage(run, label: str):
    """Device ms per frame of the stage ``label`` (from each of its stamps to
    the next stamp of its graph); None where no such stamp ran."""
    return per_frame(run, lambda p: p["stage_ms"].get(label), device=True)
