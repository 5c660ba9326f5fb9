"""The readings a cell's limits are set from: the program's compared numbers
and its control's (the reference in TF32 in the program's place) over many
seeds, in one process, on the card:

    python benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 --out <file>

Each seed is a fresh fleet (set-up, a short window at the cell's own load,
the judge twice); one JSON line per seed goes to standard output and to
``--out``."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import main as harness
    from benchmark.run import cache_dirs

    cache_dirs()
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            out = harness.run(args.workload, seed, args.seconds, False, control=True)
            line = json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                               "checks": out["checks"], "control": out["control_checks"],
                               "metrics": out["metrics"], "s": time.perf_counter() - t0})
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
