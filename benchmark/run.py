"""Run one cell of the benchmark once, on the card:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as one JSON object on the
last line of standard output, and each compared number beside its limit as
the last lines of standard error. Exits with 2, printing no result, where
there is no card (or fewer than the cell needs), or where JAX or the JAX
package is loaded once the window has closed; with 1 on any other error."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at a fixed path."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import main as harness

    try:
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START)
        for name, c in out["checks"].items():
            print(f"check {name} = {c['value']!r} limit {c['limit']!r} ({c['at']})",
                  file=sys.stderr)
        harness.refuse_forbidden()
    except (harness.NoCard, harness.Forbidden) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
