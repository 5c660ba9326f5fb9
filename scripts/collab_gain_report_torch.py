#!/usr/bin/env python3
"""Collaborative-gain report of the port (counterpart of the reference's
``scripts/collab_gain_report.py``): the trajectory ATE of a degraded agent
solo and with a full-map exchange round every 5 frames (the reference
claims up to 46 % improvement). Prints one JSON line.

    python3 scripts/collab_gain_report_torch.py                 # on the card
    python3 scripts/collab_gain_report_torch.py --device cpu    # on the CPU

Runs ``utils/collab_eval.run_collab_gain`` at the reference's configuration
(``configs.collab_gain_params`` / ``collab_gain_ccfg``, float64) on its
simulation: ``make_circle_sim`` at 100 Hz IMU, 10 Hz camera, 30 landmarks,
60 matches, 5e-4 pixel noise, seed 1.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from x_multi_agent_torch import configs  # noqa: E402
from x_multi_agent_torch.utils.collab_eval import run_collab_gain  # noqa: E402
from x_multi_agent_torch.utils.sim import make_circle_sim  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=3.0, help="seconds of flight")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    params = configs.collab_gain_params()
    sim = make_circle_sim(duration=args.duration, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                          match_budget=params.cfg.tracks.n_matches, pixel_noise=5e-4, seed=1)
    res = run_collab_gain(params, configs.collab_gain_ccfg(), sim, device=args.device)
    print(json.dumps({
        "metric": "collab_ate_gain",
        "ate_solo_m": round(res.ate_solo, 4),
        "ate_collab_m": round(res.ate_collab, 4),
        "ate_helper_m": round(res.ate_helper, 4),
        "gain_pct": round(100 * res.gain, 1),
        "exchange_rounds": res.n_rounds,
        "cross_agent_matches": res.n_matches,
        "reference_claim_pct": 46.0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
