"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, each configuration's file, each traffic file
(``benchmark/traffic/<name>.json``), each cell's limits
(``benchmark/limits/<cell>.json``), each per-layer metric's reader
(``benchmark/metrics/<name>.py``, a module with ``read(run)``) and each
traffic driver a traffic file names (``benchmark/drivers/<name>.py``)."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """A cell with everything it names: its manifest entry (``entry``), its
    configuration (``config``), its traffic (``mix``), its limits
    (``limits``), and the metrics it reports with ``--trace 0``
    (``end_to_end``) and ``--trace 1`` (``per_layer``)."""
    man = load(root)
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    cfg = {c["name"]: c for c in man["configs"]}[entry["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    bench = root / BENCH_DIR.name
    with open(bench / "traffic" / f"{entry['traffic']}.json") as f:
        mix = json.load(f)
    with open(bench / "limits" / f"{name}.json") as f:
        limits = json.load(f)

    def mine(m):
        return name in m.get("workloads", [name])

    return {"entry": entry, "config": config, "mix": mix, "limits": limits,
            "chips": int(entry["chips"]),
            "end_to_end": [m for m in man["end_to_end"] if mine(m)],
            "per_layer": [m for m in man["per_layer"] if mine(m)]}


def module(kind: str, name: str, root: Path = ROOT):
    """The module ``benchmark/<kind>/<name>.py`` under ``root``, loaded from
    its file as a module of this package's ``<kind>``."""
    full = f"{__package__.rsplit('.', 1)[0]}.{kind}.{name}"
    if full not in sys.modules:
        path = root / BENCH_DIR.name / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(full, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[full] = mod
    return sys.modules[full]


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` of a per-layer metric's module."""
    return module("metrics", metric, root).read


def driver(mix: dict, defaults: dict, root: Path = ROOT) -> SimpleNamespace:
    """The hooks that drive a traffic mix: those its ``driver`` module
    defines, and the harness's ``defaults`` for the rest (all of them where
    the traffic file names no driver)."""
    mod = module("drivers", mix["driver"], root) if "driver" in mix else None
    return SimpleNamespace(**{hook: getattr(mod, hook, fn) for hook, fn in defaults.items()})
