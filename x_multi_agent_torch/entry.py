"""The port's forward step with example inputs (counterpart of the
reference's ``__graft_entry__.entry``).

``entry()`` returns ``(fn, example_args)``: one camera frame's filter step
at the flagship dims, an IMU batch then the match-driven visual update
(track classification, state management, the stacked EKF update) at the
buffer tail, for one agent (A = 1 leading). The reference's multi-device
dry run (``__graft_entry__.dryrun_multichip``) is
``parallel.dryrun.dryrun_multichip``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import configs
from .device import resolve
from .ops import linalg
from .parallel.mesh import agent_step_fn
from .vio import pipeline
from .vio import track_manager as tm
from .vio import vio as vio_mod


def entry(device=None):
    """``(fn, (fs, slots, times, seqs, w_m, a_m, meas_time, meas))``:
    ``fn(*args) -> (fs, slots, applied (1,))`` at
    ``configs.flagship_params()`` (float32) on ``device`` (``None``: the
    card). The inputs are the reference's: 16 IMU samples at rest (5 ms
    apart, specific force +g), 200 matches with ids 0..199 and points drawn
    from ``default_rng(0)`` (N(0, 0.2^2), prev then cur), all valid; the
    measurement at the last IMU sample's time. ``fn`` raises on CUDA when
    TF32 matmuls are on."""
    device = resolve(device)
    params = configs.flagship_params()
    dt = params.tdtype
    fs, slots = vio_mod.init_at_time(params, 0.0, 1, device)

    n_imu = 16
    times = torch.as_tensor(np.arange(1, n_imu + 1) * 0.005, dtype=dt, device=device)[None]
    seqs = torch.arange(n_imu, dtype=torch.int32, device=device)[None]
    w_m = torch.zeros((1, n_imu, 3), dtype=dt, device=device)
    a_m = torch.tensor([0.0, 0.0, 9.81], dtype=dt, device=device).expand(1, n_imu, 3).clone()

    j = params.cfg.tracks.n_matches
    rng = np.random.default_rng(0)
    prev = rng.normal(size=(j, 2)) * 0.2
    cur = rng.normal(size=(j, 2)) * 0.2
    matches = tm.Matches.of(
        track_id=torch.arange(j, dtype=torch.int32, device=device)[None],
        prev_pt=torch.as_tensor(prev, dtype=dt, device=device)[None],
        cur_pt=torch.as_tensor(cur, dtype=dt, device=device)[None],
        valid=torch.ones((1, j), dtype=torch.bool, device=device),
    )
    meas = pipeline.FrameMeasurement.from_matches(params.cfg, matches)
    step = agent_step_fn(params)

    def fn(fs, slots, times, seqs, w_m, a_m, meas_time, meas):
        linalg.require_fp32_matmul(fs.cov.device, "entry")
        return step(fs, slots, times, seqs, w_m, a_m, meas_time, meas)

    return fn, (fs, slots, times, seqs, w_m, a_m, times[:, -1], meas)
