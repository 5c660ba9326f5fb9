#!/usr/bin/env python3
"""Scaling sweep of the port on one card (counterpart of the reference's
``scripts/scaling_report.py``): the match-driven filter step's throughput
and the image-driven frame step's frame rate against the agent count, and
the batch-1 update latency.

    python3 scripts/scaling_report_torch.py [--out SCALING_TORCH.md]
    SCALE_AGENTS=1,2 SCALE_IMG_AGENTS=1 \\
        python3 scripts/scaling_report_torch.py --device cpu   # a CPU rehearsal

Sweeps (``x_multi_agent_torch/utils/bench.py``): ``SCALE_AGENTS``
(1,8,32,64,128,256,512) through ``bench_matches`` at 20 steps (20 warm-up,
20 timed; the last 3 warm-up steps under ``torch.profiler``: the
device-busy ms and idle share, and the host's kernel launch calls and
CUDA-graph launches per step; the steps are the compiled programs), ``SCALE_IMG_AGENTS`` (1,4,8,16,32) through ``bench_image`` at 8
frames on 480x640 frames, ``bench_batch1_latency``. Prints the tables,
headed with the card's ``nvidia-smi`` name and power limit; writes them to
``--out`` only when it is given (never to the reference's ``SCALING.md``).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from x_multi_agent_torch import configs  # noqa: E402
from x_multi_agent_torch.device import resolve  # noqa: E402
from x_multi_agent_torch.utils import bench  # noqa: E402

TRACED = 3  # warm-up steps of each filter-step point under the profiler


def _agents(name: str, default: str) -> list:
    return [int(a) for a in os.environ.get(name, default).split(",") if a]


def _num(x, digits: int) -> str:
    """A trace's number, or "not measured" (on the CPU, or where the trace
    dropped device events)."""
    return "not measured" if x is None else f"{x:.{digits}f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the tables (markdown) to this file")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = configs.flagship_params()
    h, w = 480, 640
    card = bench.card_line(dev) or f"{dev} (host clock; not a device time)"

    rows = []
    for a in _agents("SCALE_AGENTS", "1,8,32,64,128,256,512"):
        st = {}
        ups = bench.bench_matches(params, a, 20, dev, stats=st, traced=TRACED)
        rows.append((a, ups, st))
        print(f"matches agents={a}: {ups:.1f} updates/s, {st['ms_per_step']:.3f} ms/step, "
              f"trace {st['trace']} ({card})", flush=True)
    img_rows = []
    for a in _agents("SCALE_IMG_AGENTS", "1,4,8,16,32"):
        st = {}
        fps = bench.bench_image(params, a, 8, h, w, dev, stats=st)
        img_rows.append((a, fps, st["ms_per_step"]))
        print(f"image agents={a}: {fps:.1f} frames/s, {st['ms_per_step']:.3f} ms/frame "
              f"({card})", flush=True)
    lat = bench.bench_batch1_latency(params, device=dev)
    print(f"batch=1 update latency: {lat:.3f} ms ({card})", flush=True)

    lines = [
        f"# Scaling report of the port ({card})", "",
        f"Match-driven filter step (10 IMU samples + the visual update with track churn), "
        f"M=N=15, {params.dtype}, 20 timed steps after 20 warm-up, the last {TRACED} warm-up "
        "steps under the profiler (idle share = 1 - device-busy / timed ms per step; launch "
        "calls counted on the host):", "",
        "| agents | updates/s/chip | updates/s/agent | ms/step | traced ms/step | "
        "device-busy ms/step | idle share | launch calls/step | graph launches/step |",
        "|---|---|---|---|---|---|---|---|---|",
        *[f"| {a} | {v:.1f} | {v / a:.1f} | {st['ms_per_step']:.3f} | "
          f"{st['trace']['wall_ms']:.3f} | {_num(st['trace'].get('device_busy_ms'), 3)} | "
          f"{_num(st.get('device_idle_share'), 4)} | {st['trace']['launch_calls']:.1f} | "
          f"{st['trace']['graph_launches']:.1f} |"
          for a, v, st in rows], "",
        f"Image-driven frame step ({h}x{w} orbit frames: pyramid, gated FAST (K1), pyramidal LK "
        f"(K2), RANSAC, the filter step), 8 timed frames after 8 warm-up:", "",
        "| agents | frames/s/chip | frames/s/agent | ms/frame |", "|---|---|---|---|",
        *[f"| {a} | {v:.1f} | {v / a:.1f} | {ms:.3f} |" for a, v, ms in img_rows], "",
        f"Single-agent (batch=1) update latency: {lat:.3f} ms (100 timed steps).",
    ]
    text = "\n".join(lines) + "\n"
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
