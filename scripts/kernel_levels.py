#!/usr/bin/env python3
"""Where the kernels' device time goes, launch by launch, on one card.

    python3 scripts/kernel_levels.py [--out F]

On the smoke's inputs (``chip_smoke.py`` phases 1, 2 and 4: frame 0 of the
16-agent orbit dataset at 480x640, its two detection levels for K1, its
200 features per agent tracked into frame 1 over three levels at half_win
10 for K2) it reports, for each launch on its own, the device time from a
CUDA graph of 20 launches (``chip_smoke.graph_ms``) and the bound (``chip_smoke.k1_work`` / ``k2_work``); for K1 the share
of pixels that pass the compass taps, and the device time when none pass
(threshold 1e9: no pixel is scored in full) and without NMS; for K2 the
histogram of the
Gauss-Newton steps the plain version takes, and the device time with the
steps capped at 1 and 3 (the rest of the time is the features' step
chains). Prints one JSON object (also written to ``--out``). Needs a CUDA
card.
"""
import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from x_multi_agent_torch import configs  # noqa: E402
from x_multi_agent_torch.utils.bench import card_line  # noqa: E402
from x_multi_agent_torch.utils.scene import orbit_dataset  # noqa: E402
from x_multi_agent_torch.vision import fast, lk  # noqa: E402

N_AGENTS, H, W = 16, 480, 640


def _bound_ms(nbytes, ops, peak):
    return max(nbytes / chip_smoke.PEAK_BYTES, ops / peak) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_levels: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    tparams = configs.flagship_tracker(configs.flagship_params().cfg.tracks.n_matches)
    thr = tparams.fast_threshold
    frames, _ = orbit_dataset(N_AGENTS, 2, H, W, dev)
    pyr0, pyr1, _, pts, _ = chip_smoke.kernel_inputs(torch, tparams, frames[0], frames[1])
    levels = chip_smoke.k2_level_inputs(torch, lk, tparams, pyr0, pyr1, pts, tparams.win_half)
    out = {"card": card_line(torch.device("cuda")), "fast": [], "lk": []}
    for lvl in range(tparams.pyramid_depth):
        img = pyr0[lvl].contiguous()
        nbytes, ops = chip_smoke.k1_work(torch, fast, img, thr)
        out["fast"].append({
            "shape": list(img.shape),
            "device_ms": chip_smoke.graph_ms(torch, lambda: fast.fast_score_nms(img, thr),
                                             fast.K1),
            "bound_ms": _bound_ms(nbytes, ops, chip_smoke.PEAK_OPS),
            "device_ms_none_pass": chip_smoke.graph_ms(
                torch, lambda: fast.fast_score_nms(img, 1e9), fast.K1),
            "device_ms_no_nms": chip_smoke.graph_ms(
                torch, lambda: fast.fast_score_nms(img, thr, nms=False), fast.K1),
            "compass_share": float(fast.compass_candidates(img, thr).float().mean()),
            "corner_share": float((fast.fast_score(img, thr) > 0).float().mean()),
        })
    for a, _ in levels:
        nbytes, flops = chip_smoke.k2_work(torch, lk, a)
        iters = lk._track_level(*a, return_iters=True)[2]
        rec = {"shape": list(a[0].shape), "bound_ms": _bound_ms(nbytes, flops, chip_smoke.PEAK_FLOPS),
               "steps_histogram": torch.bincount(iters.reshape(-1).long(),
                                                 minlength=a[7] + 1).tolist()}
        for cap in (1, 3, a[7]):
            capped = a[:7] + (cap,) + a[8:]
            rec[f"device_ms_steps_{cap}"] = chip_smoke.graph_ms(
                torch, lambda: lk.track_level(*capped), lk.K2)
        out["lk"].append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
