"""Inputs and twins of the REQUEST_COMM fusion chain's tests
(``tests/test_torch_fuse_chain.py``): a fleet at the RAL'22 filter's size
(M = N = 10, buffer 128, update lag 16, float32), the responses a round
hands its requesters, and the loops ``collab.fuse_chain_desc`` replaced:
one ``collab.fuse_with_peer_desc`` call per response, in the rounds as they
were written before the chain. ``mesh.spawn_agents`` children and the
card's ``gpu`` tests import this module, so it imports no JAX."""
import contextlib
import dataclasses

import torch

from x_multi_agent_torch.ekf import ekf as ekf_mod
from x_multi_agent_torch.ekf.state import StateDims
from x_multi_agent_torch.ops import linalg
from x_multi_agent_torch.parallel import collab, multihost
from x_multi_agent_torch.parallel import mesh as pmesh
from x_multi_agent_torch.place_recognition import database as db_mod
from x_multi_agent_torch.utils import timing, tree
from x_multi_agent_torch.vio import pipeline
from x_multi_agent_torch.vio import track_manager as tm
from x_multi_agent_torch.vio.vio import VioParams

# the dimensions, track budgets and update lag of benchmark/configs/rcomm-m10n10-vga-a64.json
PARAMS = VioParams(
    cfg=pipeline.VioConfig(
        dims=StateDims(n_poses=10, n_features=10, buffer_size=128),
        tracks=tm.TrackDims(n_slam=10, n_poses=10, n_opp=40, n_matches=100, n_msckf=8,
                            n_short=6, n_new_slam=10),
        min_track_length=6, enable_range=False, enable_sun=False,
    ),
    dtype="float32", max_update_lag=16,
)
CCFG = collab.CollabConfig()  # the cell's exchange: the defaults, every responder fused
SNAPSHOTS = (12, 20, 25, 30)  # frames whose payloads make the responders' pool
N_FRAMES = SNAPSHOTS[-1]
BEHIND = {3: 6, 9: 3}  # agent: IMU samples its anchor lies behind its head
OUT_OF_WINDOW = 11  # an agent in standby (status 1)
NO_HIT = 5  # an agent no responder answers


def drive(device, n_agents: int = 16):
    """``multihost.shared_drive``'s fleet at :data:`PARAMS`: frames
    0..``N_FRAMES`` of the eager filter step, a keyframe into each ring
    every frame (4 a ring, the served bitmap as wide as the fleet), then
    the corner cases: the agents of :data:`BEHIND` take that many IMU
    samples of the next frame (their anchors behind their heads, inside the
    window), agent :data:`OUT_OF_WINDOW` is put in standby. Returns (fs,
    slots, db, words, pool): the pool holds every agent's keyframe payload
    at each frame of :data:`SNAPSHOTS`, leaves (len(SNAPSHOTS) x A, ...)."""
    fs, slots, frames, words = multihost.shared_drive(PARAMS, n_agents, N_FRAMES + 1, device)
    db_dims = db_mod.DbDims(n_keyframes=4, n_words=int(words.shape[0]), max_agents=n_agents)
    db = db_mod.KeyframeDB.zero(db_dims, collab.extract_payload_desc(PARAMS, fs, slots))
    step = pmesh.agent_step(PARAMS)
    snaps = []
    for f, x in enumerate(frames[:-1]):
        fs, slots, _ = step(fs, slots, *x)
        own = collab.extract_payload_desc(PARAMS, fs, slots)
        db = db_mod.add_keyframe(db_dims, db, own, words)
        if f in SNAPSHOTS:
            snaps.append(own)
    times, seqs, w_m, a_m = frames[-1][:4]
    for agent, n in BEHIND.items():
        moved = ekf_mod.process_imu_batch_impl(PARAMS.ekf_params, fs, times[:, :n], seqs[:, :n],
                                               w_m[:, :n], a_m[:, :n])
        fs = tree.where(torch.arange(n_agents, device=fs.head.device) == agent, moved, fs)
    status = fs.status.clone()
    status[OUT_OF_WINDOW] = 1
    fs = dataclasses.replace(fs, status=status)
    return fs, slots, db, words, tree.cat(snaps)


def responses(pool, n_agents: int, n_responders: int = 64, seed: int = 0):
    """The responses of one round: ``kf_by_req`` (P responders, A
    requesters, ...) drawn from ``pool``, every requester's responders in
    order (``sel`` (A, P), as ``top_k_peers`` 0 gives them) and which carry
    a hit (``sel_valid`` (A, P), about 40 % true; none for agent
    :data:`NO_HIT`)."""
    dev = pool.time.device
    g = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, pool.time.shape[0], (n_responders, n_agents), generator=g).to(dev)
    kf_by_req = tree.map_leaves(lambda x: x[pick], pool)
    sel = torch.arange(n_responders, dtype=torch.int32, device=dev).expand(n_agents, n_responders)
    sel_valid = (torch.rand((n_agents, n_responders), generator=g) < 0.4).to(dev)
    sel_valid[NO_HIT] = False
    return kf_by_req, sel, sel_valid


def to_dtype(obj, dtype):
    """Every floating leaf of ``obj`` in ``dtype``."""
    return tree.map_leaves(lambda x: x.to(dtype) if x.is_floating_point() else x, obj)


def loop_chain(params, ccfg, fs, slots, kf_by_req, sel, sel_valid, sampler=None):
    """The loop ``collab.fuse_chain_desc`` replaced: one
    ``fuse_with_peer_desc`` call per column of ``sel``, as the sharded
    round's fusion ran it."""
    ar = torch.arange(sel.shape[0], device=sel.device)
    ns = []
    for kk in range(sel.shape[1]):
        b = sel[:, kk].long()
        kf = tree.map_leaves(lambda x: x[b, ar], kf_by_req)
        fs, n, _ = collab.fuse_with_peer_desc(params, ccfg, fs, slots, kf, sel_valid[:, kk],
                                              sampler=sampler)
        ns.append(n)
    return fs, torch.stack(ns, dim=1)


def loop_request_response_round(params, ccfg, words, fs, slots, db, sampler=None):
    """``collab.request_response_round`` as it was written before the
    chain: the responders' answers, then one ``fuse_with_peer_desc`` call
    per kept response."""
    linalg.require_fp32_matmul(fs.cov.device, "request_response_round")
    a = fs.cov.shape[0]
    dev = fs.cov.device
    ids = torch.arange(a, device=dev)
    vlads = collab.query_vlad(words, slots)
    idx_cols, hit_cols, score_cols = [], [], []
    for r in range(a):
        idx, found, score, db = db_mod.find_candidate_scored(
            db, r, vlads[r].expand_as(vlads), ccfg.pr_score_thr
        )
        idx_cols.append(idx)
        hit_cols.append(found & (ids != r))
        score_cols.append(score)
    kf_idx = torch.stack(idx_cols, 1)
    hit_grid = torch.stack(hit_cols, 1)
    score_grid = torch.stack(score_cols, 1)
    sel, sel_valid = collab.top_k_select(hit_grid.T, score_grid.T, ccfg.top_k_peers)
    ns = []
    for kk in range(sel.shape[1]):
        b = sel[:, kk].long()
        kf_row = kf_idx[b, ids].long()
        kf = tree.map_leaves(lambda x: x[b, kf_row], db.payload)
        fs, n, _ = collab.fuse_with_peer_desc(params, ccfg, fs, slots, kf, sel_valid[:, kk],
                                              sampler=sampler)
        ns.append(n)
    hits_kept = torch.zeros((a, a), dtype=torch.int32, device=dev).scatter_reduce(
        1, sel.long(), sel_valid.to(torch.int32), "amax") > 0
    n_matches = torch.stack(ns, dim=1)
    timing.tally("round_hits", hits_kept)
    timing.tally("round_matches", n_matches)
    return fs, db, hits_kept, n_matches


@contextlib.contextmanager
def looped():
    """Inside: every round fuses through :func:`loop_chain`."""
    chain = collab.fuse_chain_desc
    collab.fuse_chain_desc = loop_chain
    try:
        yield
    finally:
        collab.fuse_chain_desc = chain


def chain_twin_rank(mesh, n_calls, fs, slots, db, words, ccfg):
    """Rank function: this rank's blocks of the full stacks through
    ``n_calls`` calls of the compiled descriptor round, then from the same
    start through the plain round fusing by :func:`loop_chain`. Rank 0
    returns {"chain": [per call outputs], "loop": [...]}, gathered in agent
    order; the others None."""
    sl = mesh.block(fs.cov.shape[0])
    f0, s, d0 = (tree.map_leaves(lambda v: v[sl].to(mesh.device), x) for x in (fs, slots, db))
    out = {}
    for mode in ("chain", "loop"):
        rnd = pmesh.sharded_collab_round_desc(PARAMS, ccfg, words, mesh,
                                              compiled=mode == "chain")
        f, d, calls = f0, d0, []
        with looped() if mode == "loop" else contextlib.nullcontext():
            for _ in range(n_calls):
                got = rnd(f, s, d)
                f, d = got[:2]
                calls.append(pmesh.gather_blocks(mesh, got))
        out[mode] = calls
    return None if mesh.rank else out
