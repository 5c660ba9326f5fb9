"""The program's own recorder (``x_multi_agent_torch/utils/timing.py``) in a
run: :func:`enable` before the fleet is built (so that the warm-up's
captures hold its device stamps), :func:`start` as the window opens,
:func:`collect` as it closes (before the traced segment), whose result the
readers of ``metrics/recorded.py`` take as ``run.program``. Where the program
has no recorder (an older commit), each step does nothing and
:func:`collect` gives None.

``harness/main.py`` does not take these steps: ``benchmark/record.py`` runs a
cell with them."""
from __future__ import annotations


def _timing():
    try:
        from x_multi_agent_torch.utils import timing
    except ImportError:
        return None
    return timing if hasattr(timing, "collect") else None


def enable() -> None:
    t = _timing()
    if t is not None:
        t.enable()


def start() -> None:
    t = _timing()
    if t is not None and t.enabled():
        t.start()


def collect():
    t = _timing()
    return t.collect() if t is not None and t.enabled() else None


def disable() -> None:
    t = _timing()
    if t is not None:
        t.disable()
