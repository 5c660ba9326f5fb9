"""One run of one cell with the program's own recorder on, on the card:

    python benchmark/record.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--record 0|1]

The run of ``benchmark/run.py`` with the steps of ``harness/recorder.py``
put around the harness's fleet and window hooks, and the per-layer metrics
that read the recorder (``METRICS``, in the manifest's form) added to the
cell's. Prints the result line with, under ``"recorded"``, the window's
throughput and device milliseconds per fleet frame, and the recording per
fleet frame: those metrics, device stages and graphs, device gaps by the
host span open at their middle, host spans, counters, and the clock's
calibration. ``--record 0`` leaves the recorder off: the run of
``benchmark/run.py``, for what recording costs."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

ALL = ["flagship-fleet64-image", "flagship-fleet512-matches", "flagship-solo-matches"]
IMAGE = ["flagship-fleet64-image"]


def _metric(name, unit, source, layer, cells):
    return {"name": name, "unit": unit, "better": "lower", "source": source, "layer": layer,
            "moves": "agent_frames_per_s", "workloads": cells}


METRICS = [
    _metric("dispatch_ms_per_frame", "ms", "host_clock", "compiled programs", ALL),
    _metric("device_gap_ms_per_frame", "ms", "device_trace", "compiled programs", ALL),
    _metric("host_syncs_per_frame", "calls", "host_clock", "compiled programs", ALL),
    _metric("filter_imu_ms_per_frame", "ms", "device_trace", "filter", ALL),
    _metric("filter_rows_ms_per_frame", "ms", "device_trace", "filter", ALL),
    _metric("filter_apply_ms_per_frame", "ms", "device_trace", "filter", ALL),
    _metric("gate_wait_ms_per_frame", "ms", "host_clock", "tracker", IMAGE),
    _metric("detect_frames_share", "%", "host_clock", "tracker", IMAGE),
    _metric("track_flow_ms_per_frame", "ms", "device_trace", "tracker", IMAGE),
    _metric("track_ransac_ms_per_frame", "ms", "device_trace", "tracker", IMAGE),
    _metric("track_detect_ms_per_frame", "ms", "device_trace", "tracker", IMAGE),
]


def _per_frame(table: dict, frames: int) -> dict:
    return {str(k): v / frames for k, v in table.items()}


def summary(workload: str, agents: int, window, program, root) -> dict:
    """The window's throughput and device ms per frame, and the recording's
    readings per fleet frame."""
    from benchmark.harness import manifest

    out = {"agent_frames_per_s": agents * window.frames / window.seconds,
           "device_ms_per_frame": window.seconds * 1e3 / window.frames, "frames": window.frames}
    if not program:
        return out
    n = program["frames"]
    run = SimpleNamespace(program=program)
    out.update(
        recorded_frames=n,
        metrics={m["name"]: manifest.reader(m["name"], root)(run)
                 for m in METRICS if workload in m["workloads"]},
        busy_ms=program["busy_ms"] / n, gap_ms=program["gap_total_ms"] / n,
        stage_ms=_per_frame(program["stage_ms"], n), graph_ms=_per_frame(program["graph_ms"], n),
        graph_calls=_per_frame(program["graph_calls"], n),
        gap_ms_by_span=_per_frame(program["gap_ms"], n), host_ms=_per_frame(program["host_ms"], n),
        counters=_per_frame(program["counters"], n),
        lost_stamps=program["lost_stamps"], loose_stamps=program["loose_stamps"],
        unmatched=program["unmatched"], clock=program["clock"])
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, record: bool = True, **kwargs):
    """``harness.main.run`` with the recorder's steps (``record``) and its
    metrics; the result line gains ``"recorded"`` (:func:`summary`)."""
    from benchmark.harness import main, manifest, recorder

    root = kwargs.get("root", manifest.ROOT)
    got = {}
    saved = main.default_hooks, main.SimpleNamespace, manifest.cell

    def hooks():
        h = saved[0]()
        fleet, window = h["Fleet"], h["window"]

        def Fleet(*args, **kw):
            if record:
                recorder.enable()
            return fleet(*args, **kw)

        def recorded_window(*args, **kw):
            recorder.start()
            got["window"] = window(*args, **kw)
            got["program"] = recorder.collect()
            return got["window"]

        h.update(Fleet=Fleet, window=recorded_window)
        return h

    def cell(name, *args, **kw):
        c = saved[2](name, *args, **kw)
        c["per_layer"] = c["per_layer"] + [m for m in METRICS if name in m["workloads"]]
        return c

    main.default_hooks, manifest.cell = hooks, cell
    main.SimpleNamespace = lambda **kw: SimpleNamespace(program=got.get("program"), **kw)
    try:
        out = main.run(workload, seed, seconds, trace, **kwargs)
    finally:
        main.default_hooks, main.SimpleNamespace, manifest.cell = saved
        recorder.disable()
    win = got["window"]
    out["recorded"] = summary(workload, out["attempted"] // win.frames, win, got["program"], root)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import main as harness
    from benchmark.run import cache_dirs

    cache_dirs()
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace), bool(args.record),
                  t_start=T_START)
        harness.refuse_forbidden()
    except (harness.NoCard, harness.Forbidden) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
