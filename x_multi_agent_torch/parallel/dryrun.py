"""The multi-rank dry run (port of ``__graft_entry__.dryrun_multichip``) and
the functions that run the sharded rounds on full agent stacks, for the
tests.

Every function that runs inside a rank is defined here, at module level:
``mesh.spawn_agents`` children import it, and this module imports no JAX;
each checks before it returns that its rank has not imported any.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from .. import configs
from ..ekf import ekf as ekf_mod
from ..place_recognition import database as db_mod
from ..place_recognition.vocabulary import train_kmajority
from ..utils import tree
from ..utils.sim import make_circle_sim
from ..vio import pipeline
from ..vio import track_manager as tm
from ..vio import vio as vio_mod
from . import collab
from . import mesh as pmesh


def _no_jax() -> None:
    """A rank of the port imports nothing of JAX or of the JAX package."""
    found = [m for m in ("jax", "x_multi_agent_tpu") if m in sys.modules]
    if found:
        raise AssertionError(f"a rank imported {found}")


def _rows(obj, sl: slice, device):
    return tree.map_leaves(lambda x: x[sl].to(device), obj)


def single_rounds(params, fs, ccfg=None, dccfg=None, words=None, slots=None, db=None) -> dict:
    """The single-process rounds on full stacks: ``request_response_round``
    under ``dccfg`` (when given), then ``collaborative_round`` under
    ``ccfg`` (when given) on its result. Returns {"desc": (fs, db, hits,
    n_matches), "full": (fs, n_matches)}, the rounds that ran."""
    out = {}
    if dccfg is not None:
        out["desc"] = collab.request_response_round(params, dccfg, words, fs, slots, db)
        fs = out["desc"][0]
    if ccfg is not None:
        out["full"] = collab.collaborative_round(params, ccfg, fs)
    return out


def sharded_rounds(mesh, params, fs, ccfg=None, dccfg=None, words=None, slots=None,
                   db=None) -> dict:
    """:func:`single_rounds` over the ranks, on this rank's blocks (fs,
    slots, db, leaves (blk, ...)): ``sharded_collab_round_desc``, then
    ``sharded_collab_round``, both compiled (the outputs are the programs'
    buffers). Returns the block outputs, keyed as
    :func:`single_rounds` keys them."""
    out = {}
    if dccfg is not None:
        out["desc"] = pmesh.sharded_collab_round_desc(params, dccfg, words, mesh)(fs, slots, db)
        fs = out["desc"][0]
    if ccfg is not None:
        out["full"] = pmesh.sharded_collab_round(params, ccfg, mesh)(fs)
    return out


def rounds_on_ranks(mesh, params, fs, ccfg=None, dccfg=None, words=None, slots=None, db=None):
    """Rank function (``mesh.spawn_agents``): :func:`sharded_rounds` on this
    rank's block of full stacks given on every rank; rank 0 returns the
    outputs gathered in agent order, with the bytes each rank shipped per
    collective ({"shipped": [dict per rank]}); the other ranks return None."""
    a = fs.cov.shape[0]
    sl = mesh.block(a)
    dev = mesh.device
    blocks = [None if x is None else _rows(x, sl, dev) for x in (fs, slots, db)]
    out = sharded_rounds(mesh, params, blocks[0], ccfg, dccfg,
                         None if words is None else words.to(dev), blocks[1], blocks[2])
    got = {k: pmesh.gather_blocks(mesh, v) for k, v in out.items()}
    shipped = _gather_shipped(mesh)
    _no_jax()
    return None if mesh.rank else {**got, "shipped": shipped}


def _gather_shipped(mesh) -> list:
    """Each rank's ``mesh.shipped`` (rank order) on rank 0."""
    names = ("payloads", "vlads", "keyframes")
    mine = torch.tensor([[mesh.shipped.get(n, 0) for n in names]], dtype=torch.int64,
                        device=mesh.device)
    every = pmesh.gather_blocks(mesh, mine)
    if every is None:
        return []
    return [dict(zip(names, row)) for row in every.tolist()]


def step_on_ranks(mesh, params, fs, slots, times, seqs, w_ms, a_ms, meas_time, meas):
    """Rank function: one ``sharded_step`` on this rank's block of full
    stacks; rank 0 returns (fs, slots, applied) gathered in agent order."""
    sl = mesh.block(fs.cov.shape[0])
    args = [_rows(x, sl, mesh.device)
            for x in (fs, slots, times, seqs, w_ms, a_ms, meas_time, meas)]
    out = pmesh.gather_blocks(mesh, pmesh.sharded_step(params, mesh)(*args))
    _no_jax()
    return out


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

N_LM, WIN = 30, 20  # landmarks; visible per agent, stride 2 -> neighbours share 18
CCFG = collab.CollabConfig(sigma_landmark=0.05, ci_slam_w=0.05, gt_match_dist=0.6,
                           match_budget=8)
DCCFG = CCFG._replace(desc_ratio_thr=0.8, desc_abs_thr=40.0, pr_score_thr=0.15,
                      pr_ransac_thr=0.01, top_k_peers=3, ci_slam_w=0.05)


def _dryrun_rank(mesh, n_agents: int):
    """Rank function of :func:`dryrun_multichip`: this rank's block of the
    fleet through one ``sharded_step`` per camera frame, the full-map round
    and the descriptor round (all compiled); rank 0 returns the fleet's
    outputs."""
    params = configs.flagship_params(small=True)
    dev, dt = mesh.device, params.tdtype
    sl = mesh.block(n_agents)
    j = params.cfg.tracks.n_matches

    # distinct trajectories over one world: per-agent phase offsets and
    # sliding landmark windows (partial overlap), each agent's own IMU noise
    sims = [make_circle_sim(duration=1.2, imu_rate=100.0, cam_rate=10.0, n_landmarks=N_LM,
                            match_budget=j, pixel_noise=5e-4, seed=1, phase=0.15 * a,
                            lm_window=(2 * a, 2 * a + WIN))
            for a in range(n_agents)]
    rng = np.random.default_rng(0)
    offsets = rng.normal(size=(n_agents, 3)) * 0.03
    r_om = 1.5 * 1.2
    v0s = np.array([[r_om * np.cos(0.15 * a), r_om * np.sin(0.15 * a), 0.0]
                    for a in range(n_agents)])
    imu_w_noise = rng.normal(size=(n_agents,) + sims[0].imu_w.shape) * 1e-4
    imu_a_noise = rng.normal(size=(n_agents,) + sims[0].imu_a.shape) * 1e-3
    fs, slots = vio_mod.init_at_time(params, 0.0, sl.stop - sl.start, dev,
                                     p=offsets[sl].astype(np.float32),
                                     v=v0s[sl].astype(np.float32))

    # per-landmark binary descriptors, a few bits flipped per agent and frame
    desc_table = rng.integers(0, 256, (N_LM, 32)).astype(np.uint8)

    def agent_desc(f):
        base = np.stack([desc_table[np.maximum(s.match_id[f], 0)] for s in sims])
        flips = (rng.random((n_agents, j, 32)) < 0.004).astype(np.uint8)
        return (base ^ (flips << rng.integers(0, 8))).astype(np.uint8)

    def block(x, dtype=None):
        t = torch.as_tensor(np.array(x)[sl], device=dev)
        return t.to(dtype) if dtype is not None else t

    step = pmesh.sharded_step(params, mesh)
    n_per = 10  # IMU samples per camera frame
    for f, t_cam in enumerate(sims[0].cam_t):
        # frame f takes samples (f*10, (f+1)*10]; sample 0 is the init time
        s_ = slice(f * n_per + 1, (f + 1) * n_per + 1)
        desc = agent_desc(f)
        matches = tm.Matches.of(
            track_id=block([s.match_id[f] for s in sims], torch.int32),
            prev_pt=block([s.match_prev[f] for s in sims], dt),
            cur_pt=block([s.match_cur[f] for s in sims], dt),
            valid=block([s.match_valid[f] for s in sims]),
            desc=block(desc), desc_valid=block([s.match_valid[f] for s in sims]),
        )
        fs, slots, applied = step(
            fs, slots, block([s.imu_t[s_] for s in sims], dt),
            block(np.broadcast_to(np.arange(s_.start, s_.stop), (n_agents, n_per)), torch.int32),
            block(np.stack([s.imu_w[s_] for s in sims]) + imu_w_noise[:, s_], dt),
            block(np.stack([s.imu_a[s_] for s in sims]) + imu_a_noise[:, s_], dt),
            torch.full((sl.stop - sl.start,), float(t_cam), dtype=dt, device=dev),
            pipeline.FrameMeasurement.from_matches(params.cfg, matches),
        )
    pos_before = ekf_mod.tail_core(fs).p

    fs, n_matches = pmesh.sharded_collab_round(params, CCFG, mesh)(fs)
    delta = torch.linalg.norm(ekf_mod.tail_core(fs).p - pos_before, dim=-1)

    words = torch.from_numpy(train_kmajority(desc_table, 16, 5).words).to(dev)
    db_dims = db_mod.DbDims(n_keyframes=4, n_words=int(words.shape[0]), max_agents=n_agents)
    proto = collab.extract_payload_desc(params, fs, slots)
    db = db_mod.add_keyframe(db_dims, db_mod.KeyframeDB.zero(db_dims, proto), proto, words)
    fs, db, hits, n_desc = pmesh.sharded_collab_round_desc(params, DCCFG, words, mesh)(
        fs, slots, db)
    got = pmesh.gather_blocks(mesh, (applied, n_matches, delta, hits, n_desc,
                                     torch.isfinite(fs.cov).flatten(1).all(1)))
    shipped = _gather_shipped(mesh)
    _no_jax()
    if mesh.rank:
        return None
    nbytes = (collab.payload_nbytes(proto), collab.vlad_nbytes(words))
    return got, shipped, nbytes


def dryrun_multichip(world_size: int, backend: str = "gloo", agents_per_rank: int = 1,
                     device=None, timeout_s: float = 600.0) -> dict:
    """The full multi-agent step over ``world_size`` spawned ranks of
    ``agents_per_rank`` agents each, at the small test dims: the sim's 12
    camera frames through ``sharded_step``, a full-map round, keyframes into
    every agent's ring and a descriptor round (``device``: each rank's, as
    ``mesh.make_agent_mesh`` takes it). Checks the reference dry run's
    conditions, raising ``AssertionError`` on the first that fails, and
    returns them with the run's counts: matches fused > 0 on both paths,
    hits <= A * top_k_peers, finite covariances, distinct per-agent
    position corrections, the match budget, no match between agents that
    share no landmark, and the gated exchange's bytes against a full
    broadcast."""
    n = world_size * agents_per_rank
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    try:
        out = pmesh.spawn_agents(_dryrun_rank, world_size, backend,
                                 "file://" + os.path.join(tmp, "init"), (n,), timeout_s, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (applied, nm, delta, hits, n_desc, finite), shipped, (pay_b, vlad_b) = out[0]
    n_hits = int(hits.sum())
    nm = nm.numpy()
    overlap = np.array([[max(0, min(2 * i + WIN, 2 * k + WIN, N_LM) - max(2 * i, 2 * k))
                         for k in range(n)] for i in range(n)])
    rec = {
        "agents": n, "ranks": world_size, "applied": applied.tolist(),
        "matches_fused": int(nm.sum()), "fused_per_agent": nm.sum(-1).tolist(),
        "fusion_delta": delta.tolist(), "hits": n_hits, "desc_fused": int(n_desc.sum()),
        "bytes_gated": n * vlad_b + n_hits * pay_b, "bytes_full": n * (n - 1) * pay_b,
        "shipped": shipped,
    }
    rec["checks"] = {
        "matches_fused": rec["matches_fused"] > 0,
        "desc_fused": rec["desc_fused"] > 0,
        "hits_within_top_k": n_hits <= n * DCCFG.top_k_peers,
        "finite_cov": bool(finite.all()),
        "distinct_corrections": len({round(d, 6) for d in rec["fusion_delta"]}) > n // 2,
        "match_budget": bool((nm <= CCFG.match_budget).all()),
        "no_match_without_overlap": bool((nm[overlap == 0] == 0).all()),
    }
    failed = [k for k, ok in rec["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"dryrun_multichip: {failed} failed: {rec}")
    return rec
