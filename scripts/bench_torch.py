#!/usr/bin/env python3
"""The port's benchmark (counterpart of the reference's ``bench.py`` main):
per-agent EKF visual-update throughput and the image pipeline's frame rate
on one card, as one JSON line.

    python3 scripts/bench_torch.py                 # on the card
    BENCH_AGENTS=4 BENCH_ITERS=3 BENCH_IMG_AGENTS=2 BENCH_IMG_ITERS=2 \\
        python3 scripts/bench_torch.py --device cpu   # a CPU rehearsal

Programs (``x_multi_agent_torch/utils/bench.py``): the match-driven filter
step at ``BENCH_AGENTS`` (512) and at 128 agents, ``BENCH_ITERS`` (20)
warm-up then timed steps; the batch-1 update latency (100 + 100 steps); the
image-driven frame step on 480x640 orbit frames at each of
``BENCH_IMG_AGENTS`` (16,32,64), ``BENCH_IMG_ITERS`` (20) warm-up then timed
frames. Timed with CUDA events around each timed window; the line carries
the card's ``nvidia-smi`` name and power limit. On ``--device cpu`` the
times are the host clock's and the line says so. Writes no file; a failed
health assert fails the run.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from x_multi_agent_torch import configs  # noqa: E402
from x_multi_agent_torch.device import resolve  # noqa: E402
from x_multi_agent_torch.utils import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = configs.flagship_params()
    h, w = 480, 640
    n_agents = int(os.environ.get("BENCH_AGENTS", "512"))
    n_steps = int(os.environ.get("BENCH_ITERS", "20"))
    img_sweep = [int(x) for x in os.environ.get("BENCH_IMG_AGENTS", "16,32,64").split(",")]
    img_steps = int(os.environ.get("BENCH_IMG_ITERS", "20"))

    updates_per_s = bench.bench_matches(params, n_agents, n_steps, dev)
    per_agent = {"128": bench.bench_matches(params, 128, n_steps, dev) / 128,
                 str(n_agents): updates_per_s / n_agents}
    lat_ms = bench.bench_batch1_latency(params, 100, dev)
    per_agent["1"] = 1e3 / lat_ms
    sweep = {str(a): bench.bench_image(params, a, img_steps, h, w, dev) for a in img_sweep}
    best = max(sweep, key=sweep.get)
    fps = sweep[best]
    print(json.dumps({
        "metric": "ekf_updates_per_s_per_chip",
        "value": updates_per_s,
        "unit": "updates/s",
        # chip aggregate against a single-agent 200 Hz C++ estimate
        "vs_baseline": updates_per_s / bench.BASELINE_UPDATES_PER_S,
        "vs_baseline_basis": "chip_aggregate_vs_single_agent_200hz",
        "updates_per_s_per_agent": per_agent,
        "frames_per_s_per_chip": fps,
        "frames_vs_baseline": fps / bench.BASELINE_FRAMES_PER_S,
        "frames_sweep": sweep,
        "frames_per_s_per_agent_best": fps / int(best),
        "img_agents": int(best),
        "img_resolution": f"{h}x{w}",
        "img_motion": "orbit_6dof",
        "batch1_update_latency_ms": lat_ms,
        "timing": "cuda events" if dev.type == "cuda" else "host clock (a CPU run)",
        "card": bench.card_line(dev),
        "device": str(dev),
        "agents": n_agents,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
