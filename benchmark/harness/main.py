"""One run of one cell: set-up, the measured window, the traced segment
(``--trace 1``), the judge, and the result line's object."""
from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import inputs, manifest
from .check import Judge
from .clock import Clock, Spans
from .fleet import PACKAGE, Fleet
from .trace import segment
from .window import run as run_window
from .window import warm_up

FORBIDDEN = ("jax", "jaxlib", "flax", "x_multi_agent_tpu")


class NoCard(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def card(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def make_reference(config: dict, agents: int):
    """The plain reference of a configuration, imported once the window has
    closed."""
    from ..reference.steps import Reference

    return Reference(config, agents)


def default_hooks() -> dict:
    """The harness's own hooks, which a traffic driver may replace
    (``benchmark/drivers``)."""
    return dict(make_ring=inputs.make_ring, Fleet=Fleet, warm_up=warm_up, window=run_window,
                segment=segment, Judge=Judge, Reference=make_reference)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sample_times(seed: int, n: int, seconds: float) -> list:
    """When in the window the judge's frames are taken: ``n`` times drawn
    from the seed over its first four fifths."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    return sorted(float(u) * 0.8 * seconds for u in torch.rand(n, generator=g, dtype=torch.float64))


def end_to_end(fleet, win, setup_s: float) -> dict:
    """The end-to-end metrics of the window (``radio_bytes_per_agent_frame``
    only where the mix has rounds)."""
    from ..metrics.work import round_radio_bytes

    agent_frames = fleet.agents * win.frames
    out = {"agent_frames_per_s": agent_frames / win.seconds,
           "frame_ms_p95": float(np.percentile(win.frame_ms, 95)),
           "setup_s": setup_s}
    if fleet.every:
        last = win.first + win.frames
        hits = [int(h.sum()) for k, h in fleet.rounds if win.first <= k < last]
        words, payload = int(fleet.words.shape[0]), fleet.payload_bytes()
        out["radio_bytes_per_agent_frame"] = sum(
            round_radio_bytes(fleet.agents, words, n, payload) for n in hits) / agent_frames
    return out


def failed_agents(fleet) -> int:
    """Agents whose covariance or IMU-rate state buffer is not finite at the
    window's close."""
    fs = fleet.fs
    bad = ~torch.isfinite(fs.cov).flatten(1).all(1) | ~torch.isfinite(fs.buffer).flatten(1).all(1)
    return int(bad.sum())


def run(workload: str, seed: int, seconds: float, trace: bool, device=None, *,
        t_start: float = None, control: bool = False, fault=None, overrides=None,
        root=manifest.ROOT) -> dict:
    """The result of one run as a dict (the keys of the result line), and
    under ``"checks"`` each compared number with its limit. ``device`` None
    is the card (and raises without one); the tests pass the CPU, a
    ``fault`` that breaks the program (called with the fleet), and
    ``overrides`` of the traffic's and the configuration's values.
    ``control`` also judges the control (the reference in TF32 in the
    program's place) on the same frames, under ``"control_checks"``."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.cell(workload, root)
    config, mix = cell["config"], dict(cell["mix"])
    for key, value in (overrides or {}).items():
        (config if key in config else mix)[key] = value
    device = card(cell["chips"]) if device is None else torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = bool(config["precision"]["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(config["precision"]["tf32"])
    hooks = manifest.driver(mix, default_hooks(), root)
    clock = Clock(device)
    spans = Spans(clock)
    t_fleet = time.perf_counter()
    fleet = hooks.Fleet(config, mix, seed, device, spans, hooks.make_ring)
    if fault is not None:
        fault(fleet)
    clock.sync()
    t_warm = time.perf_counter()
    record0 = {"k": 0, "before": None}
    first = hooks.warm_up(fleet, clock, mix["warmup_frames"], mix["warmup_max"], record0)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: imports and start {t_fleet - t_start:.3f}, inputs and "
          f"state {t_warm - t_fleet:.3f}, {first} warm-up frames {t_start + setup_s - t_warm:.3f}",
          file=sys.stderr)
    spans.on = bool(trace)
    win = hooks.window(fleet, clock, first, seconds, sample_times(seed, mix["checks"], seconds))
    spans.on = False
    fm = np.asarray(win.frame_ms)
    print(f"window {win.seconds:.3f} s, {win.frames} frames: ms mean {fm.mean():.4f} median "
          f"{np.median(fm):.4f} p95 {np.percentile(fm, 95):.4f} max {fm.max():.4f}; frames cover "
          f"{fm.sum() / 1e3 / win.seconds:.4f} of the window", file=sys.stderr)
    span_ms = {name: spans.ms(name) for name in list(spans.marks)}
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = failed_agents(fleet)
    tr = None
    if trace:
        from x_multi_agent_torch import native

        tr = hooks.segment(fleet, clock, first + win.frames, mix["trace_frames"], native.KERNELS)
    e2e = end_to_end(fleet, win, setup_s)
    run_info = SimpleNamespace(config=config, mix=mix, agents=fleet.agents, window=win,
                               spans=span_ms, trace=tr)
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            value = manifest.reader(m["name"], root)(run_info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] in e2e}
    # the program's state and programs go before the reference runs
    fleet.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from ..reference.steps import PACKAGE as REF_PKG

    t_judge = time.perf_counter()
    judged = []
    for ctl in (False, True) if control else (False,):
        ref = hooks.Reference(config, fleet.agents)
        judge = hooks.Judge(fleet, ref, REF_PKG, PACKAGE, device, ctl)
        for rec in [record0] + win.records:
            judge.record(rec)
        judged.append({name: {"value": value, "limit": cell["limits"][name], "at": where}
                       for name, (value, where) in judge.numbers().items()})
    checks = judged[0]
    print(f"judge {time.perf_counter() - t_judge:.3f} s over {1 + len(win.records)} frames",
          file=sys.stderr)
    checks["failed_agents"] = {"value": failed, "limit": 0, "at": "non-finite state at the close"}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    out = {"correct": correct, "attempted": fleet.agents * win.frames, "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    if control:
        out["control_checks"] = judged[1]
    out["checks"] = checks
    refuse_forbidden()
    return out


def refuse_forbidden() -> None:
    """Raise where JAX or the JAX package is loaded: the run's last step, so
    that the window, the traced segment, the reference and the judge are
    all covered."""
    bad = forbidden_modules()
    if bad:
        raise Forbidden(f"loaded once the window had closed: {', '.join(bad)}")
