"""Trajectory-level collaborative gain (port of
``x_multi_agent_tpu.utils.collab_eval``).

Two agents fly the same simulated scene; agent B starts ``offset`` metres
off under a prior that knows it (an error single-agent VIO cannot observe).
Each agent runs the :class:`..vio.vio.VIO` facade (compiled); the
collaborative pass runs the compiled full-map exchange round
(``collab.collaborative_round_fn``) every ``exchange_every`` frames. The metric
is agent B's full-trajectory ATE, solo against collaborative.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..parallel import collab
from ..utils import tree
from ..vio import track_manager as tm
from ..vio import vio as vio_mod
from .evaluation import ate_rmse, nees


class CollabGainResult(NamedTuple):
    ate_solo: float  # degraded agent, no exchange [m]
    ate_collab: float  # degraded agent, periodic exchange rounds [m]
    ate_helper: float  # well-initialized agent in the collab run [m]
    gain: float  # 1 - ate_collab / ate_solo
    n_rounds: int
    n_matches: int  # cross-agent landmark matches applied in total
    mean_nees_collab: float = float("nan")  # degraded agent, collab pass


def _new_agent(params: vio_mod.VioParams, offset, sigma_dp, device):
    v = vio_mod.VIO(params._replace(sigma_dp=(sigma_dp,) * 3), device=device)
    v.init_at_time(0.0, p=np.asarray(offset, float), v=np.array([1.8, 0.0, 0.0]))
    return v


def run_collab_gain(
    params: vio_mod.VioParams,
    ccfg: collab.CollabConfig,
    sim,
    offset: float = 0.4,
    exchange_every: int = 5,
    device=None,
) -> CollabGainResult:
    """``sim``: a match-driven simulation with the fields of the reference's
    ``utils.sim.SimData`` (numpy), e.g. ``make_circle_sim(duration,
    imu_rate=100, cam_rate=10, n_landmarks=30,
    match_budget=params.cfg.tracks.n_matches, pixel_noise, seed)`` as the
    reference's ``run_collab_gain`` builds it."""
    device = resolve(device)

    def frame_matches(f):
        def b(x):
            return torch.as_tensor(x, device=device)[None]

        return tm.Matches.of(
            track_id=b(sim.match_id[f]).to(torch.int32),
            prev_pt=b(sim.match_prev[f]).to(params.tdtype),
            cur_pt=b(sim.match_cur[f]).to(params.tdtype),
            valid=b(sim.match_valid[f]),
        )

    def host(x):  # a copy: on the CPU a facade's state is its programs' buffer
        return x[0].cpu().numpy().copy()

    def drive(collaborate: bool):
        # the compiled full-map round (the reference's collaborative_round_jit)
        round_fn = collab.collaborative_round_fn(params, ccfg)
        va = _new_agent(params, (0.0, 0.0, 0.0), 1e-3, device)
        vb = _new_agent(params, (offset, 0.0, 0.0), max(0.5, 2 * offset), device)
        est_a, est_b, anchor_b, cov_b = [], [], [], []
        imu_i = 0
        n_rounds = n_matches = 0
        for f, t_cam in enumerate(sim.cam_t):
            while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
                for v in (va, vb):
                    v.process_imu(sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i])
                imu_i += 1
            matches = frame_matches(f)
            for v in (va, vb):
                v.process_matches_measurement(t_cam, f, matches)
            if collaborate and (f + 1) % exchange_every == 0:
                fs = tree.cat([va.fs, vb.fs])
                fs, nm = round_fn(fs)
                # views of the round's buffers, copied into each facade's own
                # by its next call (before the next round writes them)
                va.fs = tree.map_leaves(lambda x: x[:1], fs)
                vb.fs = tree.map_leaves(lambda x: x[1:], fs)
                n_rounds += 1
                n_matches += int(nm.sum())
            est_a.append(host(va.tail_state().p))
            est_b.append(host(vb.tail_state().p))
            anchor_b.append(host(vb.anchor_state().p))
            cov_b.append(host(vb.fs.cov[:, :3, :3]))
        return (np.array(est_a), np.array(est_b), n_rounds, n_matches,
                np.array(anchor_b), np.array(cov_b))

    gt = sim.cam_p
    _, solo_b, _, _, _, _ = drive(collaborate=False)
    collab_a, collab_b, n_rounds, n_matches, anchor_b, cov_b = drive(collaborate=True)
    # degraded agent's position NEES on the collaborative pass (anchor state
    # at frame times, warm-up skipped)
    mean_nees = float(np.mean(nees(anchor_b[5:], gt[5:], cov_b[5:])))
    ate_solo = ate_rmse(solo_b, gt)
    ate_collab = ate_rmse(collab_b, gt)
    return CollabGainResult(
        ate_solo=float(ate_solo), ate_collab=float(ate_collab),
        ate_helper=float(ate_rmse(collab_a, gt)), gain=float(1.0 - ate_collab / ate_solo),
        n_rounds=n_rounds, n_matches=n_matches, mean_nees_collab=mean_nees,
    )
