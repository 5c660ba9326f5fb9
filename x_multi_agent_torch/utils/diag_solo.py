"""Solo-replay stage diagnostics (port of the reference's
``scripts/diag_solo.py``).

Replays one agent of the thermal 6-DoF dataset solo with single stages
switched off, to isolate which stage injects filter overconfidence or
divergence:

  --no-photo        no online photometric correction
  --no-spatial      global gain correction only (no spatial map)
  --clean-thermal   a dataset variant rendered without the baked thermal
                    degradation (its own directory)
  --degraded        the degraded agent's cheap IMU (and its filter margins)
  --sigma-img-px X  tracker/filter image noise in pixels (default 2.0)
  --imu-scale X     scale all ImuNoise densities (default 1.0)
  --no-oc           no observability-constrained projection
  --no-health       no health monitor (no automatic re-init)
  --frames N        replay only the first N frames (default 250)
  --agent K         which agent's dataset (default 0)

Prints the reference's one-line JSON summary and writes the replay's trace
to ``DATASET_ROOT/trace_{tag}_a{agent}.npz``. Entry points run on the card
unless ``device`` says otherwise; the CLI is ``scripts/diag_solo_torch.py``.
"""
from __future__ import annotations

import argparse
import json
import os

from . import ate_report as ar


def parse_args(argv=None):
    """The reference's flags."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--agent", type=int, default=0)
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--sigma-img-px", type=float, default=2.0)
    ap.add_argument("--imu-scale", type=float, default=1.0)
    ap.add_argument("--no-photo", action="store_true")
    ap.add_argument("--no-spatial", action="store_true")
    ap.add_argument("--no-oc", action="store_true")
    ap.add_argument("--no-health", action="store_true")
    ap.add_argument("--clean-thermal", action="store_true")
    ap.add_argument("--degraded", action="store_true")
    ap.add_argument("--tag", type=str, default="diag")
    return ap.parse_args(argv)


def overrides_from_args(args) -> dict:
    """The ``build_agent`` overrides the flags select."""
    overrides = dict(sigma_img_px=args.sigma_img_px, imu_noise_scale=args.imu_scale,
                     obs_constrained=not args.no_oc)
    if args.no_photo:
        overrides["photometric"] = None
    elif args.no_spatial:
        overrides["photometric"] = dict(n_obs=80, spatial=False, cell_px=80, spatial_every=20)
    if args.no_health:
        overrides["health"] = None
    return overrides


def dataset(args, h: int = 480, w: int = 640, device=None):
    """The agent's meta: the thermal-free variant (``agent{a}_clean``) with
    ``--clean-thermal``, else the ATE report's dataset of agents 0..agent
    (the agent degraded with ``--degraded``)."""
    if args.clean_thermal:
        return ar.ensure_variant_dataset(args.agent, "clean", args.duration, None, ar.MOTION,
                                         gen_key="clean", h=h, w=w, device=device)
    metas = ar.ensure_dataset(args.agent + 1, args.duration, h, w,
                              degraded_idx=args.agent if args.degraded else -1, device=device)
    return metas[args.agent]


def run(args, h: int = 480, w: int = 640, device=None) -> dict:
    """One diagnostic replay; returns (and prints) the summary."""
    overrides = overrides_from_args(args)
    meta = dataset(args, h, w, device)
    v = ar.build_agent(meta, args.degraded, None, None, args.agent, collab=False,
                       overrides=overrides, device=device)
    r = ar.replay([v], [meta], exchange=False, max_frames=args.frames,
                  trace_path=os.path.join(ar.DATASET_ROOT, f"trace_{args.tag}_a{args.agent}.npz"))
    out = dict(
        tag=args.tag, agent=args.agent, frames=args.frames,
        overrides={k: bool(x) if isinstance(x, dict) else x for k, x in overrides.items()},
        clean_thermal=args.clean_thermal,
        ate=round(r["ate"][0], 4),
        ate_aligned=round(r["ate_aligned"][0], 4),
        final_err=round(r["final_err"][0], 4),
        mean_nees=round(r["mean_nees"][0], 2),
        max_nees=round(r["max_nees"][0], 1),
        n_reinits=r["n_reinits"][0],
        wall_s=r["wall_s"],
    )
    print(json.dumps(out))
    return out


def main(argv=None, device=None) -> dict:
    return run(parse_args(argv), device=device)
