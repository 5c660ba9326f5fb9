"""PyTorch port: the REQUEST_COMM round's fusion chain
(``collab.fuse_chain_desc``) against the loop it replaced, one
``collab.fuse_with_peer_desc`` call per response (``torch_rcomm_chain``'s
twins, copies of the rounds as they were before the chain).

At the RAL'22 filter's size (M = N = 10, buffer 128, update lag 16), 16
requesters against 64 responders, with the corner cases the chain must
keep: responders with no hit, a requester with none, a requester out of the
window, anchors several IMU samples behind the head. Held bit for bit, every
leaf of the state and the match counts:

* the chain against the loop, float32 and float64, RANSAC on and off, the
  consistency gate off and on;
* ``request_response_round`` against its loop twin over 2 calls from one
  start (the served bitmap carried), every responder and the top 3;
* the compiled descriptor round on 2 gloo ranks against the plain round
  fusing by the loop, 3 calls from one start;
* on a card (``gpu``-marked, skipped here): the chain against the loop at
  the four-card cell's shapes (16 requesters, 64 responders) and the
  single-process round's (16 against 16), the batched
  gates against the per-response ones, and 3 compiled rounds at NCCL world
  size 1 against the plain round fusing by the loop, one graph launch a
  call; it prints the eager kernel launches of one chain step before and
  after.

No JAX: the card's machine runs the ``gpu`` tests with ``python -m pytest
--noconftest -m gpu tests/test_torch_fuse_chain.py``.
"""
import pytest
import torch

import torch_rcomm_chain as rc
from x_multi_agent_torch.parallel import collab
from x_multi_agent_torch.parallel import mesh as pmesh
from x_multi_agent_torch.utils import tree

N_CALLS = 3
GEOM_TOL = 0.01  # m: the consistency gate keeps about half of the matches here


def _same(a, b) -> bool:
    """Every leaf equal (``torch.equal``; NaN where the other has NaN)."""
    la, lb = tree.leaves(a), tree.leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.is_floating_point():
            nx, ny = torch.isnan(x), torch.isnan(y)
            if not (torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def _ccfg(ransac: bool, geom: bool):
    return rc.CCFG._replace(pr_ransac_thr=rc.CCFG.pr_ransac_thr if ransac else 0.0,
                            geom_consistency_tol=GEOM_TOL if geom else 0.0)


@pytest.fixture(scope="module")
def fleet():
    """(fs, slots, db, words, pool) of ``torch_rcomm_chain.drive`` on the
    CPU."""
    return rc.drive("cpu")


def _check_chain(fs, slots, kf, sel, sel_valid, ccfg):
    want = rc.loop_chain(rc.PARAMS, ccfg, fs, slots, kf, sel, sel_valid)
    got = collab.fuse_chain_desc(rc.PARAMS, ccfg, fs, slots, kf, sel, sel_valid)
    assert _same(got, want)
    fs1, n = got
    assert int(n.sum()) > 0
    assert int(n[rc.NO_HIT].sum()) == 0 and int(n[rc.OUT_OF_WINDOW].sum()) == 0
    out = rc.OUT_OF_WINDOW
    assert _same(tree.map_leaves(lambda x: x[out], fs1), tree.map_leaves(lambda x: x[out], fs))
    for agent in rc.BEHIND:  # the one propagation moved the anchor to the head
        assert int(fs.anchor_buf_idx[agent]) != int(fs.head[agent])
        assert int(fs1.anchor_buf_idx[agent]) == int(fs1.head[agent])
    return got


@pytest.mark.parametrize("geom", [False, True], ids=["geom-off", "geom-on"])
@pytest.mark.parametrize("ransac", [True, False], ids=["ransac-on", "ransac-off"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_chain_equals_loop(fleet, dtype, ransac, geom):
    """16 requesters fuse 64 responses each (about 40 % of them hits):
    the chain equals the loop bit for bit; the requester with no hit and
    the one out of the window fuse nothing, the latter's state untouched;
    the anchors behind the head end at the head."""
    fs, slots, _, _, pool = fleet
    kf, sel, sel_valid = rc.responses(pool, fs.head.shape[0])
    fs, slots, kf = (rc.to_dtype(x, dtype) for x in (fs, slots, kf))
    _check_chain(fs, slots, kf, sel, sel_valid, _ccfg(ransac, geom))


def test_chain_gates_bite(fleet):
    """The gates the parametrized cases switch change the result: RANSAC
    and the consistency gate each drop matches the other cases fuse."""
    fs, slots, _, _, pool = fleet
    kf, sel, sel_valid = rc.responses(pool, fs.head.shape[0])
    counts = {(r, g): int(collab.fuse_chain_desc(rc.PARAMS, _ccfg(r, g), fs, slots, kf, sel,
                                                 sel_valid)[1].sum())
              for r in (True, False) for g in (True, False)}
    assert counts[(True, False)] < counts[(False, False)]
    assert counts[(True, True)] < counts[(True, False)]


def test_chain_counters(fleet):
    """With the recorder on, the chain tallies the requesters the one
    propagation moved (the anchors behind the head), and the CI mend's
    dropped matches as the loop does."""
    from x_multi_agent_torch.utils import timing

    fs, slots, _, _, pool = fleet
    kf, sel, sel_valid = rc.responses(pool, fs.head.shape[0])
    ccfg = rc.CCFG._replace(ci_slam_w=0.9)  # a heavy peer: some S fail to factorize
    got = {}
    timing.disable()
    try:
        for name, fn in (("loop", rc.loop_chain), ("chain", collab.fuse_chain_desc)):
            timing.start()
            timing.enable()
            fn(rc.PARAMS, ccfg, fs, slots, kf, sel, sel_valid)
            got[name] = timing.collect()["counters"]
            timing.disable()
    finally:
        timing.disable()
        timing.start()
    assert got["chain"]["round_propagated"] == len(rc.BEHIND)
    assert got["chain"]["ci_dropped"] == got["loop"]["ci_dropped"] > 0


def test_chain_without_responses_is_identity(fleet):
    """No column: the state as it came, no match."""
    fs, slots, _, _, pool = fleet
    kf, sel, sel_valid = rc.responses(pool, fs.head.shape[0])
    fs1, n = collab.fuse_chain_desc(rc.PARAMS, rc.CCFG, fs, slots, kf, sel[:, :0],
                                    sel_valid[:, :0])
    assert fs1 is fs and n.shape == (fs.head.shape[0], 0)


@pytest.mark.parametrize("top_k", [0, 3])
def test_request_response_round_equals_loop(fleet, top_k):
    """``request_response_round`` against its loop twin, 2 calls from one
    start, the served bitmap carried: every output bit for bit."""
    fs, slots, db, words, _ = fleet
    ccfg = rc.CCFG._replace(top_k_peers=top_k)
    got, want = (fs, db), (fs, db)
    fused = 0
    for _ in range(2):
        g = collab.request_response_round(rc.PARAMS, ccfg, words, got[0], slots, got[1])
        w = rc.loop_request_response_round(rc.PARAMS, ccfg, words, want[0], slots, want[1])
        assert _same(g, w)
        got, want = g[:2], w[:2]
        fused += int(g[3].sum())
    assert fused > 0


def test_gloo_compiled_round_equals_loop(tmp_path, fleet):
    """The compiled descriptor round on 2 gloo ranks of 8 agents against
    the plain round fusing by the loop, 3 calls from one start."""
    fs, slots, db, words, _ = fleet
    got = pmesh.spawn_agents(rc.chain_twin_rank, 2, "gloo", f"file://{tmp_path}/init",
                             (N_CALLS, fs, slots, db, words, rc.CCFG), 240.0, device="cpu")[0]
    for k in range(N_CALLS):
        assert _same(got["chain"][k], got["loop"][k]), f"call {k}"
    assert int(got["chain"][0][3].sum()) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_fleet():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return rc.drive(torch.device("cuda"))


def _launches(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    from x_multi_agent_torch.utils.bench import launch_calls

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return launch_calls(prof)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("n_responders", [64, 16], ids=["sharded4", "single16"])
def test_gpu_chain_equals_loop_at_cell_shapes(cuda_fleet, n_responders):
    """On the card, 16 requesters against 64 responders as on each of the
    four-card cell's ranks, and against 16 as in the single-process round
    of 16 agents (``request_response_round``, the pending one-card cell):
    the batched gates (kNN and RANSAC over every pair) equal the
    per-response gates, and the chain equals the loop bit for bit, RANSAC
    on and off, the consistency gate off and on. Prints the eager kernel
    launches of a loop step and of a chain step."""
    fs, slots, _, _, pool = cuda_fleet
    a = fs.head.shape[0]
    kf, sel, sel_valid = rc.responses(pool, a, n_responders)
    m = rc.PARAMS.cfg.dims.n_poses
    k = sel.shape[1]
    own_pts = slots.slam_obs[:, :, m - 1]
    pairs = tree.map_leaves(lambda x: x[sel.long(), torch.arange(a, device=x.device)[:, None]],
                            kf)
    flat = tree.map_leaves(lambda x: x.reshape((a * k,) + x.shape[2:]), pairs)

    def rep(x):
        return x[:, None].expand((a, k) + x.shape[1:]).reshape((a * k,) + x.shape[1:])

    sampler = collab.KeyedSampler()
    batched = collab._desc_matches(rc.CCFG, rep(slots.slam_desc), rep(slots.slam_desc_valid),
                                   rep(own_pts), flat, rep(fs.head), sampler)
    per = [collab._desc_matches(rc.CCFG, slots.slam_desc, slots.slam_desc_valid, own_pts,
                                tree.map_leaves(lambda x: x[:, j], pairs), fs.head, sampler)
           for j in range(k)]
    per = tuple(torch.stack([p[i] for p in per], 1).reshape(a * k, -1) for i in range(2))
    assert _same(batched, per), "the batched gates differ from the per-response ones"
    for ransac in (True, False):
        for geom in (False, True):
            _check_chain(fs, slots, kf, sel, sel_valid, _ccfg(ransac, geom))

    ccfg = rc.CCFG
    one = tree.map_leaves(lambda x: x[sel[:, 0].long(), torch.arange(a, device=x.device)], kf)
    step_before = _launches(lambda: collab.fuse_with_peer_desc(rc.PARAMS, ccfg, fs, slots, one,
                                                               sel_valid[:, 0]))
    chain_k = _launches(lambda: collab.fuse_chain_desc(rc.PARAMS, ccfg, fs, slots, kf, sel,
                                                       sel_valid))
    chain_1 = _launches(lambda: collab.fuse_chain_desc(rc.PARAMS, ccfg, fs, slots, kf,
                                                       sel[:, :1], sel_valid[:, :1]))
    step_after = (chain_k - chain_1) / (k - 1)
    print(f"\neager kernel launches, {a} requesters x {k} responders: a loop step "
          f"{step_before} ({k * step_before} a round's fusion), a chain step {step_after:.1f}, "
          f"the chain {chain_k} (once: {chain_1 - step_after:.1f})")


@pytest.mark.gpu
def test_gpu_nccl_round_equals_loop(cuda_fleet, tmp_path):
    """At NCCL world size 1 on the card, the 16 agents: 3 compiled
    descriptor rounds from one start, each bit for bit equal to the plain
    round fusing by the loop, one graph launch per call after the first
    and no host sync."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from x_multi_agent_torch.utils.bench import launch_calls

    fs, slots, db, words, _ = cuda_fleet
    mesh = pmesh.make_agent_mesh("nccl", f"file://{tmp_path}/nccl", 0, 1, fs.cov.device)
    try:
        rounds = {c: pmesh.sharded_collab_round_desc(rc.PARAMS, rc.CCFG, words, mesh,
                                                     compiled=c) for c in (True, False)}
        state = {c: (fs, db) for c in rounds}
        fused = 0
        for k in range(N_CALLS):
            with rc.looped():
                want = tree.map_leaves(torch.clone, rounds[False](state[False][0], slots,
                                                                  state[False][1]))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode(1)
                try:
                    with profile(activities=[ProfilerActivity.CPU]) as prof:
                        got = rounds[True](state[True][0], slots, state[True][1])
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            got = tree.map_leaves(torch.clone, got)
            if k:
                calls, graphs = launch_calls(prof)
                assert graphs == 1 and calls < 10, (k, calls, graphs)
                assert not [w for w in caught if "called a synchronizing" in str(w.message)]
            assert _same(got, want), f"call {k}"
            state = {True: got[:2], False: want[:2]}
            fused += int(got[3].sum())
        assert fused > 0
    finally:
        torch.distributed.destroy_process_group()
