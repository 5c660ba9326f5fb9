#!/usr/bin/env python3
"""Spread of the port's ATE report over the base seed of its random draws.

Every RANSAC draw of the port is keyed on (seed, state)
(``x_multi_agent_torch/ops/ransac.py``); the report runs with seed 0. This
script renders (or reuses) the report's dataset once, then runs
``ate_report.run_report`` at the CLI's defaults with ``--vocab random`` once
per seed given, all seeds at the same time, each in its own process on the
one card. It prints each seed's numbers (aligned ATE solo and
collaborative, mean NEES, matches fused, re-inits, hits, bytes, the
degraded agent's gain, wall time) and their range over the seeds.

    XMAT_DATASET_DIR=/path/to/datasets python3 scripts/ate_seed_spread.py \\
        --seeds 1 2 3 [--duration 60] [--out-dir ate_seeds]

Seed s keeps its solo caches, checkpoints and traces in
``XMAT_DATASET_DIR/seed{s}`` beside symbolic links to the shared dataset;
its report goes to ``OUT_DIR/seed{s}.json`` and its log to
``OUT_DIR/seed{s}.log``. A cut run resumes from its checkpoints when
started again with the same flags.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def report_args(duration: float, agents: int):
    from x_multi_agent_torch.utils import ate_report

    return ate_report.parse_args(["--vocab", "random", "--duration", str(duration),
                                  "--agents", str(agents)])


def worker(seed: int, duration: float, agents: int, out: str) -> int:
    """One seed's report (``XMAT_DATASET_DIR`` is the seed's directory)."""
    import torch

    from x_multi_agent_torch.utils import ate_report

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    rep, _ = ate_report.run_report(report_args(duration, agents), seed=seed)
    rep = dict(rep, seed=seed, wall_s=round(time.perf_counter() - t0, 1))
    with open(out, "w") as f:
        json.dump(rep, f, indent=2)
    return 0


def summary(reps) -> None:
    cols = dict(
        ate_solo=lambda r: r["per_agent"]["ate_solo_m"],
        ate_collab=lambda r: r["per_agent"]["ate_collab_m"],
        nees_solo=lambda r: r["per_agent"]["mean_nees_solo"],
        nees_collab=lambda r: r["per_agent"]["mean_nees_collab"],
        max_nees_collab=lambda r: r["per_agent"]["max_nees_collab"],
        fused=lambda r: r["per_agent"]["rr_fused"],
        reinits=lambda r: r["per_agent"]["n_reinits"],
        hits=lambda r: r["request_comm"]["hits"],
        bytes_rr=lambda r: r["request_comm"]["bytes_request_response"],
        bytes_full=lambda r: r["request_comm"]["bytes_full_broadcast"],
        gain_pct=lambda r: r["degraded_agent"]["collab_gain_pct"],
        keyframes=lambda r: r["keyframes_selected"],
        wall_s=lambda r: r["wall_s"],
    )
    for r in reps:
        print(json.dumps(dict(seed=r["seed"], **{k: f(r) for k, f in cols.items()})))
    rng = {}
    for k, f in cols.items():
        vals = [f(r) for r in reps]
        if isinstance(vals[0], list):
            rng[k] = [[min(v), max(v)] for v in zip(*vals)]
        else:
            rng[k] = [min(vals), max(vals)]
    print(json.dumps(dict(seeds=[r["seed"] for r in reps], range=rng)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--out-dir", type=str, default="ate_seeds")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    if args.worker is not None:
        return worker(args.worker, args.duration, args.agents,
                      os.path.join(args.out_dir, f"seed{args.worker}.json"))

    from x_multi_agent_torch.utils import ate_report

    a = report_args(args.duration, args.agents)
    t0 = time.perf_counter()
    metas = ate_report.ensure_dataset(a.agents, a.duration, a.height, a.width,
                                      degraded_idx=a.degraded)
    print(f"dataset: {time.perf_counter() - t0:.1f} s", flush=True)
    procs = []
    try:
        for s in args.seeds:
            root = os.path.join(ate_report.DATASET_ROOT, f"seed{s}")
            os.makedirs(root, exist_ok=True)
            for m in metas:
                link = os.path.join(root, os.path.basename(m["dir"]))
                if not os.path.lexists(link):
                    os.symlink(os.path.abspath(m["dir"]), link)
            log = open(os.path.join(args.out_dir, f"seed{s}.log"), "w")
            cmd = [sys.executable, os.path.abspath(__file__), "--worker", str(s),
                   "--duration", str(args.duration), "--agents", str(args.agents),
                   "--out-dir", args.out_dir]
            procs.append((s, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                   env=dict(os.environ, XMAT_DATASET_DIR=root))))
        rcs = {s: p.wait() for s, _, p in procs}
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    print(f"seeds {args.seeds}: exit codes {rcs}, {time.perf_counter() - t0:.1f} s", flush=True)
    reps = []
    for s in args.seeds:
        path = os.path.join(args.out_dir, f"seed{s}.json")
        if os.path.exists(path):
            with open(path) as f:
                reps.append(json.load(f))
    if reps:
        summary(reps)
    return 0 if len(reps) == len(args.seeds) and not any(rcs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
