"""Tiny sizes of the benchmark's cells for the CPU tests: two agents, 96x128
frames of a 256-texel wall, a 20-frame ring. The filter keeps its
configuration's dimensions."""
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("flagship-fleet64-image", "rcomm-fleet16-exchange", "flagship-fleet512-matches",
         "flagship-solo-matches")  # the exchange cell from benchmark/pending/
SEED = 4_000_000_017  # more than 32 bits: a check may draw seeds that large


def overrides(workload: str) -> dict:
    ov = {"agents": 2, "trace_frames": 3}
    if "image" in workload or "exchange" in workload:
        ov.update(ring_frames=20, texture_size=256, image={"height": 96, "width": 128},
                  camera={"fx": 102.4, "fy": 102.4, "cx": 64.0, "cy": 48.0, "s": 0.0,
                          "width": 128, "height": 96},
                  warmup_frames=3 if "image" in workload else 12)
    if "exchange" in workload:  # a round every other frame: a short window on a slow CPU has some
        ov["exchange_every"] = 2
    return ov


def root_for(workload: str) -> Path:
    """The checkout's root, or for a cell kept in ``benchmark/pending/`` a
    temporary root whose ``BENCHMARK.json`` holds the pending entries too."""
    pending = ROOT / "benchmark" / "pending" / f"{workload}.json"
    if not pending.exists():
        return ROOT
    tmp = Path(tempfile.mkdtemp(prefix="bench-root-"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in json.loads(pending.read_text()).items():
        if key in man:
            man[key] += entries
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    (tmp / "benchmark").symlink_to(ROOT / "benchmark")
    return tmp


def run(workload: str, seconds: float = 1.5, trace: bool = False, **kwargs) -> dict:
    from benchmark.harness import main

    return main.run(workload, kwargs.pop("seed", SEED), seconds, trace, device="cpu",
                    overrides=overrides(workload), root=root_for(workload), **kwargs)
