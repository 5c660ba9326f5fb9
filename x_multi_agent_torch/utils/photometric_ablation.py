"""Photometric ablation (port of the reference's
``scripts/photometric_ablation.py``): does the per-cell spatial
photometric path earn its keep?

Renders a spatially dominated thermal variant of agent 0's trajectory
(strong corner vignette, no gain drift, low noise: the regime the spatial
map exists for) and replays it solo under three photometric modes:

    off      no online correction
    global   global-gain correction only (the ATE report's default)
    spatial  global gains + the per-cell spatial map + GPR

Prints one JSON line per mode (ATE, NEES, re-inits) and a verdict line.
Entry points run on the card unless ``device`` says otherwise; the CLI is
``scripts/photometric_ablation_torch.py``.
"""
from __future__ import annotations

import argparse
import json

from . import ate_report as ar

# the modes' ``photometric`` overrides of ``ate_report.build_agent``
PHOTOMETRIC = {
    "off": None,
    "global": dict(n_obs=80, spatial=False, cell_px=80, spatial_every=20),
    "spatial": dict(n_obs=80, spatial=True, cell_px=80, spatial_every=20),
}


def parse_args(argv=None):
    """The reference's flags."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--vignette", type=float, default=0.30)
    ap.add_argument("--noise", type=float, default=0.004)
    ap.add_argument("--sigma-img-px", type=float, default=14.0)
    ap.add_argument("--modes", type=str, default="off,global,spatial")
    # the port's own: where and in what precision the filter runs (the
    # tracker's kernels take float32 on the card, so float64 runs on the CPU)
    ap.add_argument("--device", type=str, default=None, help="default: the card")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    return ap.parse_args(argv)


def ensure_vignette_dataset(duration: float, vignette: float, noise: float, h: int = 480,
                            w: int = 640, device=None):
    """Agent 0's vignette-dominated variant (``agent0_vign{100 v}``), the
    reference's ``gen_key``."""
    thermal = dict(drift_a=0.0, drift_b=0.0, noise=noise, vignette=vignette)
    return ar.ensure_variant_dataset(0, f"vign{int(vignette * 100)}", duration, thermal,
                                     ar.MOTION, gen_key=dict(thermal=thermal, duration=duration),
                                     h=h, w=w, device=device)


def run_mode(meta, mode: str, frames: int, sigma_img_px: float, device=None,
             dtype: str = "float32") -> dict:
    """One solo replay under photometric ``mode``, the filter in ``dtype``."""
    overrides = dict(sigma_img_px=sigma_img_px, photometric=PHOTOMETRIC[mode])
    v = ar.build_agent(meta, False, None, None, 0, collab=False, overrides=overrides,
                       device=device, dtype=dtype)
    r = ar.replay([v], [meta], exchange=False, max_frames=frames)
    return dict(
        ate_aligned=round(r["ate_aligned"][0], 4),
        ate=round(r["ate"][0], 4),
        mean_nees=round(r["mean_nees"][0], 2),
        n_reinits=r["n_reinits"][0],
    )


def verdict(vignette: float, results: dict) -> dict:
    """Whether the spatial mode's aligned ATE is below 0.9x the global's."""
    g, s = results["global"], results["spatial"]
    improves = s["ate_aligned"] < 0.9 * g["ate_aligned"]
    return dict(vignette=vignette, spatial_improves_ate=bool(improves),
                ate_global=g["ate_aligned"], ate_spatial=s["ate_aligned"])


def main(argv=None, h: int = 480, w: int = 640, device=None) -> dict:
    """Every mode of ``--modes``, one JSON line each, then the verdict when
    both global and spatial ran. Returns the results per mode, with the
    verdict under ``"verdict"``."""
    args = parse_args(argv)
    device = args.device or device
    meta = ensure_vignette_dataset(args.duration, args.vignette, args.noise, h, w, device)
    results = {}
    for mode in args.modes.split(","):
        results[mode] = run_mode(meta, mode, args.frames, args.sigma_img_px, device, args.dtype)
        print(json.dumps({mode: results[mode]}), flush=True)
    if "global" in results and "spatial" in results:
        results["verdict"] = verdict(args.vignette, results)
        print(json.dumps(results["verdict"]))
    return results
