"""Harsh-envelope recovery study (port of the reference's
``scripts/harsh_recovery.py``).

Renders a thermal variant of one agent's 6-DoF trajectory outside the
comfortable tracking envelope (stronger vignette, noise and rotation than
the ATE report's dataset; optionally the degraded agent's cheap IMU and a
total camera blackout over a window of frames) and replays it solo with the
health monitor off and on. The claim under test: divergence detection and
automatic re-initialization (``VIO.enable_health_monitor``) turn an
unbounded divergence into a bounded-error run with ``n_reinits > 0``.

The names, flags and JSON fields are the reference's. Entry points run on
the card unless ``device`` says otherwise; the CLI is
``scripts/harsh_recovery_torch.py``.
"""
from __future__ import annotations

import argparse
import json

from . import ate_report as ar

PRESETS = dict(
    # the reference's harshest point of its round 3
    harsh=dict(
        thermal=dict(drift_a=0.004, drift_b=0.001, noise=0.008, vignette=0.10),
        motion=dict(yaw_amp=0.12, pitch_amp=0.08, roll_amp=0.06, z_amp=0.2),
    ),
    # beyond it: stronger vignette, noise and rotation
    extreme=dict(
        thermal=dict(drift_a=0.004, drift_b=0.001, noise=0.014, vignette=0.18),
        motion=dict(yaw_amp=0.16, pitch_amp=0.11, roll_amp=0.08, z_amp=0.25),
    ),
    # tracking-killing: near-blackout vignette, heavy noise, fast rotation;
    # the monitor's starved-frame gate and re-init must bound it
    blackout=dict(
        thermal=dict(drift_a=0.004, drift_b=0.001, noise=0.030, vignette=0.32),
        motion=dict(yaw_amp=0.20, pitch_amp=0.14, roll_amp=0.10, z_amp=0.3),
    ),
)

SIGMA_IMG_PX = 14.0


def ensure_harsh_dataset(agent: int, duration: float, preset: str, cheap_imu: bool = False,
                         h: int = 480, w: int = 640, device=None):
    """Agent ``agent``'s dataset under ``preset`` (``agent{a}_{preset}``,
    ``_cheap`` with the degraded agent's IMU), the reference's ``gen_key``.
    The preset's thermal and motion settings come back in
    ``meta["gen_key"]``."""
    cfg = PRESETS[preset]
    w_f = ar.DEG_GYRO_FACTOR if cheap_imu else 1.0
    a_f = ar.DEG_ACCEL_FACTOR if cheap_imu else 1.0
    gen_key = dict(thermal=cfg["thermal"], motion=cfg["motion"], duration=duration, w_f=w_f,
                   a_f=a_f)
    return ar.ensure_variant_dataset(
        agent, f"{preset}_cheap" if cheap_imu else preset, duration, cfg["thermal"],
        cfg["motion"], w_f, a_f, gen_key=gen_key, h=h, w=w, device=device,
    )


def run(meta, agent: int, health: bool, frames: int, cheap_imu: bool = False, outage=None,
        device=None, seed: int = 0) -> dict:
    """One solo replay of the first ``frames`` frames, the health monitor
    on or off, the camera black over ``outage`` = (first, end)."""
    overrides = dict(sigma_img_px=SIGMA_IMG_PX)
    if not health:
        overrides["health"] = None
    v = ar.build_agent(meta, cheap_imu, None, None, agent, collab=False, overrides=overrides,
                       device=device, seed=seed)
    r = ar.replay([v], [meta], exchange=False, max_frames=frames, outage=outage)
    return dict(
        health_monitor=health,
        ate=round(r["ate"][0], 3),
        ate_aligned=round(r["ate_aligned"][0], 3),
        final_err=round(r["final_err"][0], 3),
        mean_nees=round(r["mean_nees"][0], 2),
        n_reinits=int(r["n_reinits"][0]),
    )


def parse_args(argv=None):
    """The reference's flags."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--agent", type=int, default=0)
    ap.add_argument("--out", type=str, default="HARSH_RECOVERY_torch.json")
    ap.add_argument("--presets", type=str, default="harsh,extreme")
    ap.add_argument("--probe-off-only", action="store_true",
                    help="run only the health-off pass per preset")
    ap.add_argument("--cheap-imu", action="store_true",
                    help="fly the degraded agent's x600-gyro IMU")
    ap.add_argument("--outage", type=str, default=None,
                    help="frame window lo:hi of a total camera blackout")
    return ap.parse_args(argv)


def gates(on: dict, off: dict) -> dict:
    """The reference's gates over one preset's two passes."""
    return dict(
        monitor_reinit_fired=on["n_reinits"] > 0,
        recovery_bounds_error=on["final_err"] < max(1.0, 0.5 * off["final_err"]),
    )


def main(argv=None, h: int = 480, w: int = 640, device=None) -> dict:
    """The study: per preset the health-off pass and (unless
    ``--probe-off-only``) the health-on pass, one JSON line each; the gates
    over the last preset; the report written to ``--out`` and returned."""
    args = parse_args(argv)
    outage = tuple(int(x) for x in args.outage.split(":")) if args.outage else None
    presets = args.presets.split(",")
    report = dict(settings={}, results={})
    for preset in presets:
        meta = ensure_harsh_dataset(args.agent, args.duration, preset, cheap_imu=args.cheap_imu,
                                    h=h, w=w, device=device)
        report["settings"][preset] = dict(
            thermal=meta["gen_key"]["thermal"], motion=meta["gen_key"]["motion"],
            duration_s=args.duration, frames=args.frames, agent=args.agent,
            sigma_img_px=SIGMA_IMG_PX, cheap_imu=args.cheap_imu, outage=args.outage,
        )
        entry = {}
        for health in (False, True) if not args.probe_off_only else (False,):
            res = run(meta, args.agent, health=health, frames=args.frames,
                      cheap_imu=args.cheap_imu, outage=outage, device=device)
            print(json.dumps({preset: res}), flush=True)
            entry["with_health_monitor" if health else "without_health_monitor"] = res
        report["results"][preset] = entry
    last = report["results"][presets[-1]]
    if "with_health_monitor" in last:
        report["gates"] = gates(last["with_health_monitor"], last["without_health_monitor"])
        print(json.dumps(report["gates"]))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")
    return report
