#!/usr/bin/env python3
"""Multi-process exchange demo of the port (counterpart of the reference's
``scripts/multihost_demo.py``): agents in blocks over gloo ranks, one
process per rank, a shared scene, and every frame the step, a keyframe
insert and the REQUEST_COMM descriptor round across the ranks, both
compiled as the reference's are jitted (the step one CUDA graph, the round
three graphs around its two host-staged gloo collectives;
``x_multi_agent_torch/parallel/multihost.py``).

    python3 scripts/multihost_demo_torch.py                  # 2 ranks x 4 agents on the card
    python3 scripts/multihost_demo_torch.py --device cpu     # the ranks on CPU tensors
    python3 scripts/multihost_demo_torch.py --sweep --out multihost_torch.json

The reference's "hosts x devices per host x agents per device" becomes
"ranks x agents per rank" (torch runs one rank per process): its default 2
x 4 x 1 is 2 ranks x 4 agents, and its sweep's (hosts, devices, agents per
device) (2, 4, 1|4|16) and (4, 2, 1|4|16) are (2 ranks, 4|16|64 agents)
and (4 ranks, 2|8|32 agents), with the top-K ablation at 2 ranks x 64. The
ranks run on gloo (NCCL refuses two ranks on one card). Prints one JSON line
per configuration (rank 0's record); ``--sweep`` writes its report to
``--out`` only when given. Fails when a configuration fuses no match.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from x_multi_agent_torch.parallel.multihost import run_demo  # noqa: E402


def launch(hosts, agents_per_rank, iters, top_k, device) -> dict:
    """One configuration's record, without its per-agent tensors."""
    rec = run_demo(hosts, agents_per_rank, iters, top_k, device)
    return {k: v for k, v in rec.items() if k not in ("counts", "applied_per_agent")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hosts", type=int, default=2, help="ranks (one process each)")
    ap.add_argument("--agents-per-rank", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8, help="timed frames after frame 0")
    ap.add_argument("--top-k", type=int, default=3, help="per-round peer budget (0 = every peer)")
    ap.add_argument("--device", default=None, help="every rank's device: cuda (default) or cpu")
    ap.add_argument("--sweep", action="store_true", help="ranks x agents sweep and top-K ablation")
    ap.add_argument("--out", help="with --sweep: write the report (JSON) to this file")
    args = ap.parse_args(argv)
    if not args.sweep:
        print(json.dumps(launch(args.hosts, args.agents_per_rank, args.iters, args.top_k,
                                args.device)))
        return 0

    points = []
    for hosts, apr in ((2, 4), (2, 16), (2, 64), (4, 2), (4, 8), (4, 32)):
        r = launch(hosts, apr, args.iters, args.top_k, args.device)
        r["agents_per_ms"] = r["agents"] / r["value"]
        points.append(r)
        print(json.dumps(r), flush=True)
    for r in points:  # a ratio, not an efficiency: it grows with agent batching
        r["throughput_ratio_vs_smallest"] = r["agents_per_ms"] / points[0]["agents_per_ms"]
    # same agent count split over 2 and 4 ranks: the 4-rank split's retention
    by_agents = {}
    for r in points:
        by_agents.setdefault(r["agents"], {})[r["hosts"]] = r
    split_eff = {str(n): d[4]["agents_per_ms"] / d[2]["agents_per_ms"]
                 for n, d in sorted(by_agents.items()) if 2 in d and 4 in d}
    topk = []
    for tk in (1, 3, 8):
        r = launch(2, 64, args.iters, tk, args.device)
        topk.append({"top_k_peers": tk, "ms_per_step": r["value"],
                     "exchange_hits": r["exchange_hits"]})
        print(json.dumps(topk[-1]), flush=True)
    report = {"transport": "torch.distributed gloo, one process per rank",
              "drive": "shared-scene (real cross-agent landmark fusion)",
              "device": points[0]["device"], "iters_per_config": args.iters, "sweep": points,
              "rank_split_efficiency_4r_vs_2r": split_eff, "top_k_ablation": topk}
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
