#!/usr/bin/env python3
"""Device times of the hand-written kernels (K1 FAST + NMS, K2 LK level) of
several builds of ``x_multi_agent_torch/csrc``, on one card, in one process.

    python3 scripts/kernel_ab.py --tree parent=DIR [--tree new=.] [--rounds 1] [--out F]

Each ``--tree NAME=DIR`` names a checkout whose ``x_multi_agent_torch/csrc``
holds one design of the kernels (for example the parent commit unpacked with
``git archive``); its sources are built with this checkout's nvcc flags into
``DIR/x_multi_agent_torch/_build`` and driven through this checkout's
wrappers (the C entry points keep one signature). The inputs are the smoke's
(``chip_smoke.py`` phases 1, 2 and 4): frame 0 of the 16-agent orbit dataset
at 480x640, its two detection levels for K1, and its 200 features per agent
tracked into frame 1 over three levels at half_win 10 for K2. The trees run
in turns (a, b, b, a for two, ``--rounds`` times), each turn timing both
kernels with ``chip_smoke.kernel_times`` (CUDA-event and profiler device
time per launch, the plain version's time, the bound). Every tree's outputs
are held against the plain versions first: K1 exactly, K2 with phase 2's
gates. Prints ptxas's report of each build and one JSON object (also written
to ``--out``). Needs a CUDA card.
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
from x_multi_agent_torch import configs, native  # noqa: E402
from x_multi_agent_torch.utils.scene import orbit_dataset  # noqa: E402
from x_multi_agent_torch.vision import fast, lk  # noqa: E402

N_AGENTS, H, W = 16, 480, 640


def check(tparams, det_levels, levels) -> dict:
    """The loaded build's K1 and K2 against their plain versions."""
    thr = tparams.fast_threshold
    k1 = max(float((fast.fast_score_nms(i, thr) - fast.nms3(fast.fast_score(i, thr))).abs().max())
             for i in det_levels)
    if k1 != 0.0:
        raise AssertionError(f"K1 differs from its plain version by {k1}")
    worst = None
    for args, (f_p, ok_p) in levels:
        f_k, ok_k = lk.track_level(*args)
        margin = lk.gate_margin(args[2], args[3], args[4], args[6], tparams.min_eig_thr)
        st = lk.level_agreement(f_p, ok_p, f_k, ok_k, margin)
        if not (st["ok_agree"] >= 0.995 and st["max_disagree_margin"] <= 1e-3
                and st["max_flow_err"] <= 2e-2 and st["share_within_1e-3"] >= 0.99):
            raise AssertionError(f"K2 differs from its plain version: {st}")
        worst = st if worst is None or st["max_flow_err"] > worst["max_flow_err"] else worst
    return {"k1_max_abs_err": k1, "k2_worst_level": worst}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    libs = {}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        pkg = Path(path).resolve() / "x_multi_agent_torch"
        libs[name] = native.load(native.build(pkg / "csrc", pkg / "_build"))
        print(f"== build {name} ({pkg}): nvcc {native.build_seconds} s\n{native.build_log.strip()}")

    tparams = configs.flagship_tracker(configs.flagship_params().cfg.tracks.n_matches)
    frames, _ = orbit_dataset(N_AGENTS, 2, H, W, dev)
    native._lib = next(iter(libs.values()))  # detection launches K1
    pyr0, pyr1, det_levels, pts, live = chip_smoke.kernel_inputs(torch, tparams, frames[0],
                                                                 frames[1])
    levels = chip_smoke.k2_level_inputs(torch, lk, tparams, pyr0, pyr1, pts, tparams.win_half)
    level_inputs = [a for a, _ in levels]

    out = {"card": chip_smoke._card_line(), "device": torch.cuda.get_device_name(0),
           "features": int(live.sum()), "checks": {}, "turns": []}
    for name, cdll in libs.items():
        native._lib = cdll
        out["checks"][name] = check(tparams, det_levels, levels)
    order = list(libs) + list(libs)[::-1]
    for _ in range(args.rounds):
        for name in order:
            native._lib = libs[name]
            t = chip_smoke.kernel_times(torch, fast, lk, det_levels, level_inputs,
                                        tparams.fast_threshold)
            out["turns"].append({"tree": name, **t})
            print(f"{name}: " + ", ".join(
                f"{k} device {r['device_ms']:.4f} ms events {r['ms']:.4f} ms "
                f"bound {r['bound_ms']:.4f} ms" for k, r in t.items()))
    out["median_device_ms"] = {
        name: {k: sorted(t[k]["device_ms"] for t in out["turns"] if t["tree"] == name)[
            sum(t["tree"] == name for t in out["turns"]) // 2] for k in ("fast", "lk")}
        for name in libs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
