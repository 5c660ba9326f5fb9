"""The multi-process exchange demo (counterpart of the reference's
``scripts/multihost_demo.py``): agents in blocks over ``torch.distributed``
ranks, one process each (``mesh.spawn_agents``, gloo, a ``file://`` init),
every camera frame a ``sharded_step``, a keyframe insert and the
descriptor round ``sharded_collab_round_desc`` across the ranks.

The reference spawns one process per "host", each with K virtual XLA
devices holding one agent each (2 hosts x 4 devices x 1 agent by default);
torch runs one rank per process, so a rank holds a block of agents (2 ranks
x 4 agents). All agents fly one shared scene (the reference's drive:
``make_circle_sim(seed=1)``, offsets from ``default_rng(0)``, per-landmark
descriptors with per-frame bit flips from ``default_rng(1000 + f)``, 16
k-majority words), so their SLAM maps hold the same landmarks and the
round fuses real cross-agent matches.

Every rank function lives here at module level (spawned children import
it); this module imports no JAX.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import configs
from ..device import resolve
from ..place_recognition import database as db_mod
from ..place_recognition.vocabulary import train_kmajority
from ..utils import tree
from ..utils.sim import make_circle_sim
from ..vio import pipeline
from ..vio import track_manager as tm
from ..vio import vio as vio_mod
from . import collab, dryrun
from . import mesh as pmesh

N_PER = 10  # IMU samples per camera frame (imu_rate / cam_rate)


def demo_ccfg(top_k: int) -> collab.CollabConfig:
    """The reference demo's exchange: descriptor ratio 0.8, absolute
    Hamming 40, VLAD score 0.15, epipolar RANSAC 0.01, peer weight 0.05,
    ``top_k`` peers per round (0: every peer)."""
    return collab.CollabConfig(desc_ratio_thr=0.8, desc_abs_thr=40.0, pr_score_thr=0.15,
                               pr_ransac_thr=0.01, ci_slam_w=0.05, top_k_peers=top_k)


def shared_drive(params: vio_mod.VioParams, n_agents: int, iters: int, device):
    """The demo's drive for all ``n_agents``: (fs, slots, frames, words),
    frames[f] = (times, seqs, w_m, a_m, meas_time, meas) for f = 0..iters,
    leaves (A, ...) on ``device``."""
    j = params.cfg.tracks.n_matches
    dt = params.tdtype
    sim = make_circle_sim(duration=(iters + 2) / 10.0, imu_rate=100.0, cam_rate=10.0,
                          n_landmarks=30, match_budget=j, pixel_noise=5e-4, seed=1)
    rng = np.random.default_rng(0)
    offsets = rng.normal(size=(n_agents, 3)).astype(np.float32) * 0.03
    desc_table = rng.integers(0, 256, (sim.landmarks.shape[0], 32)).astype(np.uint8)
    fs, slots = vio_mod.init_at_time(params, 0.0, n_agents, device, p=offsets,
                                     v=np.array([1.8, 0.0, 0.0], np.float32))

    def bcast(x, dtype=dt):
        x = np.asarray(x)
        return torch.as_tensor(np.broadcast_to(x, (n_agents,) + x.shape).copy(),
                               device=device).to(dtype)

    def frame(f):
        sl = slice(f * N_PER + 1, (f + 1) * N_PER + 1)
        drng = np.random.default_rng(1000 + f)
        flips = (drng.random((n_agents, j, 32)) < 0.004).astype(np.uint8)
        desc = (desc_table[np.maximum(sim.match_id[f], 0)][None]
                ^ (flips << drng.integers(0, 8))).astype(np.uint8)
        valid = bcast(sim.match_valid[f], torch.bool)
        matches = tm.Matches.of(track_id=bcast(sim.match_id[f], torch.int32),
                                prev_pt=bcast(sim.match_prev[f].astype(np.float32)),
                                cur_pt=bcast(sim.match_cur[f].astype(np.float32)), valid=valid,
                                desc=torch.as_tensor(desc, device=device), desc_valid=valid)
        return (bcast(sim.imu_t[sl].astype(np.float32)),
                bcast(np.arange(sl.start, sl.stop), torch.int32),
                bcast(sim.imu_w[sl].astype(np.float32)), bcast(sim.imu_a[sl].astype(np.float32)),
                torch.full((n_agents,), float(np.float32(sim.cam_t[f])), dtype=dt, device=device),
                pipeline.FrameMeasurement.from_matches(params.cfg, matches))

    words = torch.from_numpy(train_kmajority(desc_table, 16, 5).words).to(device)
    return fs, slots, [frame(f) for f in range(iters + 1)], words


def _exchange_loop(params, n_agents, fs, slots, frames, words, step, round_fn):
    """Frame 0 (the reference's compile step, not counted), then frames
    1..iters: the step, the keyframe insert, the round. Returns (seconds of
    frames 1..iters, per-agent (hits, matches) per frame (blk, iters, 2),
    the last frame's applied (blk,))."""
    db_dims = db_mod.DbDims(n_keyframes=4, n_words=int(words.shape[0]), max_agents=n_agents)
    db = db_mod.KeyframeDB.zero(db_dims, collab.extract_payload_desc(params, fs, slots))
    dev = fs.cov.device
    counts = []
    for k, x in enumerate(frames):
        if k == 1:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        fs, slots, applied = step(fs, slots, *x)
        db = db_mod.add_keyframe(db_dims, db, collab.extract_payload_desc(params, fs, slots), words)
        fs, db, hits, n_matches = round_fn(fs, slots, db)
        if k:
            counts.append(torch.stack([hits.sum(1), n_matches.sum(1)], 1))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, torch.stack(counts, 1), applied


def demo_rank(mesh, n_agents: int, iters: int, top_k: int):
    """Rank function of :func:`run_demo`: this rank's block of the shared
    drive. Rank 0 returns {"seconds", "counts" (A, iters, 2), "applied"
    (A,)} gathered in agent order; the others return None."""
    params = configs.flagship_params(small=True)
    sl = mesh.block(n_agents)
    fs, slots, frames, words = shared_drive(params, n_agents, iters, mesh.device)

    def rows(x):
        return tree.map_leaves(lambda v: v[sl].contiguous(), x)

    seconds, counts, applied = _exchange_loop(
        params, n_agents, rows(fs), rows(slots), [rows(x) for x in frames], words,
        pmesh.sharded_step(params, mesh),
        pmesh.sharded_collab_round_desc(params, demo_ccfg(top_k), words, mesh))
    got = pmesh.gather_blocks(mesh, (counts, applied))
    dryrun._no_jax()
    return None if mesh.rank else {"seconds": seconds, "counts": got[0], "applied": got[1]}


def single_process(n_agents: int, iters: int, top_k: int, device=None) -> dict:
    """The same drive in this process on all agents at once: the step, the
    keyframe insert and ``collab.request_response_round`` (through
    ``dryrun.single_rounds``). Returns what rank 0 of :func:`run_demo`
    gathers."""
    params = configs.flagship_params(small=True)
    fs, slots, frames, words = shared_drive(params, n_agents, iters, resolve(device))
    ccfg = demo_ccfg(top_k)

    def round_fn(fs, slots, db):
        return dryrun.single_rounds(params, fs, dccfg=ccfg, words=words, slots=slots,
                                    db=db)["desc"]

    seconds, counts, applied = _exchange_loop(params, n_agents, fs, slots, frames, words,
                                              pmesh.agent_step_fn(params), round_fn)
    return {"seconds": seconds, "counts": counts.cpu(), "applied": applied.cpu()}


def run_demo(hosts: int, agents_per_rank: int, iters: int, top_k: int = 3, device=None,
             timeout_s: float = 900.0) -> dict:
    """``hosts`` gloo ranks of ``agents_per_rank`` agents each (``device``:
    every rank's; ``None`` is the card, and raises here without one),
    ``iters`` timed frames after frame 0. Returns the reference's record: ms per frame of the whole fleet
    (step, keyframe insert, descriptor round), hits and matches fused over
    the timed frames, whether every agent applied its last update; raises
    ``AssertionError`` when no match was fused."""
    n = hosts * agents_per_rank
    device = resolve(device)
    tmp = tempfile.mkdtemp(prefix="multihost_")
    try:
        out = pmesh.spawn_agents(demo_rank, hosts, "gloo", "file://" + os.path.join(tmp, "init"),
                                 (n, iters, top_k), timeout_s, device)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {
        "metric": "multihost_step_plus_exchange_ms", "hosts": hosts,
        "agents_per_rank": agents_per_rank, "agents": n, "top_k_peers": top_k,
        "value": out["seconds"] / iters * 1e3,
        "unit": "ms/frame (visual update + IMU batch + keyframe insert + VLAD request-response "
                "descriptor exchange round, all ranks)",
        "applied": bool(out["applied"].all()), "exchange_hits": int(out["counts"][..., 0].sum()),
        "exchange_matches": int(out["counts"][..., 1].sum()), "device": str(device),
        "counts": out["counts"], "applied_per_agent": out["applied"],
    }
    if rec["exchange_matches"] <= 0:
        raise AssertionError(f"the exchange fused no match: {rec}")
    return rec
