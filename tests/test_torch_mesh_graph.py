"""PyTorch port: the compiled sharded rounds (``parallel/mesh.py``:
``ShardedRound``), the counterparts of the reference's jitted
``sharded_collab_round`` and ``sharded_collab_round_desc``.

With gloo a compiled round is one graph per segment between its
collectives (on the CPU each runs as a function on the program's static
buffers), the collectives host steps between them; with NCCL one CUDA graph
holds the whole round, its collectives inside. On 2 gloo ranks spawned on
the CPU (``mesh.spawn_agents``; the rank function lives in
``torch_mesh_ranks.py``, which imports no JAX) these tests hold:

* the compiled rounds against their plain twins (``compiled=False``) over
  3 calls from one start, every leaf bit for bit, with ``top_k`` 0 and 2
  and the keyed RANSAC gate on, and the bytes each twin counted in
  ``mesh.shipped`` equal;
* every graph segment of both rounds, after its first call, under
  ``CaptureWitness``: nothing that breaks a capture;
* the compiled rounds against the reference's sharded rounds on 2 virtual
  devices (``test_torch_mesh.py``'s inputs and tolerances), each called 3
  times on its own output, so the carry (the served bitmap included)
  threads through the calls;
* on a card (``gpu``-marked, skipped here): both rounds compiled against
  their plain twins with 2 gloo ranks on the card; at NCCL world size 1
  each compiled round one graph launch per call, no host sync, bit for bit
  against its plain twin.

JAX is imported inside the tests that compare with it, so the card's
machine runs the ``gpu`` test with ``python -m pytest --noconftest -m gpu
tests/test_torch_mesh_graph.py``.
"""
import numpy as np
import pytest
import torch

from x_multi_agent_torch.parallel import collab as tcollab
from x_multi_agent_torch.parallel import mesh as tmesh
from x_multi_agent_torch.utils import tree

REL = 1e-8  # test_torch_mesh.py's tolerance against the reference
N_CALLS = 3
# the graphs of one capture key: the full-map round's two segments, the
# descriptor round's three
FULL_GRAPHS = [f"sharded_collab_round:0:{i}" for i in range(2)]
DESC_GRAPHS = [f"sharded_collab_round_desc:0:{i}" for i in range(3)]


@pytest.fixture(scope="module")
def desc_inputs():
    """The reference's mesh-descriptor inputs (``torch_helpers``)."""
    from torch_helpers import mesh_desc_inputs

    return mesh_desc_inputs()


@pytest.fixture(scope="module")
def four_agents(desc_inputs):
    """Four agents, two per rank (``torch_helpers``)."""
    from torch_helpers import mesh_four_agents

    return mesh_four_agents(desc_inputs)


def _spawn(tmp_path, *args, device="cpu") -> list:
    """``torch_mesh_ranks.twin_rounds_rank`` on 2 gloo ranks, both on
    ``device``."""
    from torch_mesh_ranks import twin_rounds_rank

    return tmesh.spawn_agents(twin_rounds_rank, 2, "gloo", f"file://{tmp_path}/init", args,
                              180.0, device=device)


def _port_ccfg(ccfg, **kw):
    return tcollab.CollabConfig(**ccfg._replace(**kw)._asdict())


def _bitwise(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def _assert_clean(found: dict, names: list) -> None:
    for name in names:
        assert name in found, f"{name} was never witnessed"
        assert not found[name], "capture-unsafe operations in " + name + ":\n" + "\n".join(
            f"== {what}\n{where}" for what, where in found[name])


@pytest.mark.parametrize("top_k", [0, 2])
def test_compiled_rounds_equal_plain_twins(tmp_path, four_agents, top_k):
    """Both rounds on 2 ranks of 2 agents, compiled and plain, 3 calls each
    from one start (the descriptor round, then the full-map round on its
    result): every leaf of every call bit for bit, the same bytes shipped
    (3 times a payload block, a VLAD block and the keyframe grid's other
    half), and every graph segment clean under the witness."""
    from test_collab import CCFG, PARAMS
    from torch_helpers import port_params

    fs, slots, db, words = four_agents
    tp = port_params(PARAMS)
    dccfg = _port_ccfg(CCFG, desc_ratio_thr=0.85, desc_abs_thr=60.0, pr_score_thr=0.05,
                       top_k_peers=top_k)
    assert dccfg.pr_ransac_thr == 0.01
    ranks = _spawn(tmp_path, tp, N_CALLS, fs, _port_ccfg(CCFG), dccfg, words, slots, db)
    got = ranks[0]
    for k in range(N_CALLS):
        for key in ("desc", "full"):
            assert _bitwise(got["compiled"][k][key], got["eager"][k][key]), f"call {k} {key}"
    first = got["compiled"][0]
    assert int(first["desc"][2].sum()) > 0 and int(first["desc"][3].sum()) > 0
    assert int(first["full"][1].sum()) > 0
    shipped = got["shipped"]
    assert shipped["compiled"] == shipped["eager"]
    pay_b = tcollab.payload_nbytes(tcollab.extract_payload(tp, fs))
    kf_b = tcollab.payload_nbytes(tcollab.extract_payload_desc(tp, fs, slots)) + 1 + 4
    want = {"payloads": N_CALLS * 2 * pay_b, "vlads": N_CALLS * 2 * tcollab.vlad_nbytes(words),
            "keyframes": N_CALLS * 2 * 2 * kf_b}
    assert shipped["compiled"] == [want, want]
    for r in ranks:
        _assert_clean(r["found"], FULL_GRAPHS + DESC_GRAPHS)


def test_compiled_full_round_matches_jax_over_three_calls(tmp_path, desc_inputs):
    """The compiled full-map round on 2 ranks, called 3 times on its own
    output, against the reference's mesh round called so on 2 virtual
    devices (the reference's two 3 s agents)."""
    import jax
    from test_collab import CCFG, PARAMS
    from torch_helpers import assert_tree_close, np_tree, port_params, to_port
    from x_multi_agent_tpu.parallel import mesh as jmesh

    fs = desc_inputs[0]
    ref_fn = jmesh.sharded_collab_round(PARAMS, CCFG, jmesh.make_agent_mesh(jax.devices()[:2]))
    got = _spawn(tmp_path, port_params(PARAMS), N_CALLS, to_port(fs), _port_ccfg(CCFG))[0]
    ref_fs = fs
    for k in range(N_CALLS):
        ref_fs, ref_nm = ref_fn(ref_fs)
        got_fs, got_nm = got["compiled"][k]["full"]
        np.testing.assert_array_equal(got_nm.numpy(), np.asarray(ref_nm), f"call {k}")
        assert_tree_close(got_fs, np_tree(ref_fs), REL, f"call {k} fs")
        assert int(got_nm.diagonal().sum()) == 0
    assert int(got["compiled"][0]["full"][1].sum()) > 0


def test_compiled_desc_round_matches_jax_over_three_calls(tmp_path, desc_inputs):
    """The compiled descriptor round on 2 ranks, called 3 times on its own
    output (the served bitmap carried: the first call serves each ring's
    keyframe, the later ones find it served), against the reference's mesh
    round called so on 2 virtual devices, the RANSAC gate off (torch cannot
    repeat the reference's draws here; the keyed draws are held against
    the plain twin above)."""
    import jax
    import jax.numpy as jnp
    from test_collab import CCFG, PARAMS
    from torch_helpers import assert_tree_close, np_tree, port_params, t, to_port
    from x_multi_agent_tpu.parallel import mesh as jmesh

    fs, slots, db, words = desc_inputs
    ccfg = CCFG._replace(desc_ratio_thr=0.85, desc_abs_thr=60.0, pr_score_thr=0.05,
                         pr_ransac_thr=0.0, top_k_peers=1, ci_slam_w=0.05)
    ref_fn = jmesh.sharded_collab_round_desc(PARAMS, ccfg, jnp.asarray(words),
                                             jmesh.make_agent_mesh(jax.devices()[:2]))
    got = _spawn(tmp_path, port_params(PARAMS), N_CALLS, to_port(fs), None,
                 _port_ccfg(ccfg), t(words), to_port(slots), to_port(db))[0]
    ref_fs, ref_db = fs, db
    for k in range(N_CALLS):
        ref_fs, ref_db, ref_hits, ref_nm = ref_fn(ref_fs, slots, ref_db)
        g_fs, g_db, g_hits, g_nm = got["compiled"][k]["desc"]
        np.testing.assert_array_equal(g_hits.numpy(), np.asarray(ref_hits), f"call {k}")
        np.testing.assert_array_equal(g_nm.numpy(), np.asarray(ref_nm), f"call {k}")
        assert_tree_close(g_db, np_tree(ref_db), 0.0, f"call {k} db")
        assert_tree_close(g_fs, np_tree(ref_fs), REL, f"call {k} fs")
    first, later = got["compiled"][0]["desc"], got["compiled"][1:]
    assert int(first[2].sum()) > 0 and int(first[3].sum()) > 0
    assert all(int(c["desc"][2].sum()) == 0 for c in later)  # every keyframe served


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _demo_state(params, device) -> tuple:
    """4 agents of the multi-process demo's drive on ``device``, 4 frames of
    the compiled filter step each followed by a keyframe insert: (fs,
    slots, db, words), cloned."""
    from x_multi_agent_torch.parallel import multihost
    from x_multi_agent_torch.place_recognition import database as db_mod

    fs, slots, frames, words = multihost.shared_drive(params, 4, 4, device)
    db_dims = db_mod.DbDims(n_keyframes=4, n_words=int(words.shape[0]), max_agents=4)
    db = db_mod.KeyframeDB.zero(db_dims, tcollab.extract_payload_desc(params, fs, slots))
    step = tmesh.agent_step_fn(params)
    for x in frames:
        fs, slots, _ = step(fs, slots, *x)
        db = db_mod.add_keyframe(db_dims, db, tcollab.extract_payload_desc(params, fs, slots),
                                 words)
    return tuple(tree.map_leaves(torch.clone, x) for x in (fs, slots, db, words))


@pytest.mark.gpu
def test_gloo_compiled_rounds_on_the_card_equal_plain_twins(cuda, tmp_path):
    """Both gloo ranks on the card (a graph per segment, each collective
    staged through pinned host memory), 2 of :func:`_demo_state`'s agents
    each: 3 calls of both compiled rounds and their plain twins from one
    start (the descriptor round, then the full-map round on its result),
    every leaf bit for bit, hits and fused matches, the same bytes
    shipped."""
    from x_multi_agent_torch import configs
    from x_multi_agent_torch.parallel import multihost

    params = configs.flagship_params(small=True)
    fs, slots, db, words = (tree.map_leaves(lambda x: x.cpu(), x)
                            for x in _demo_state(params, cuda))
    ccfg = multihost.demo_ccfg(2)
    got = _spawn(tmp_path, params, N_CALLS, fs, ccfg, ccfg, words, slots, db, device=cuda)[0]
    for k in range(N_CALLS):
        for key in ("desc", "full"):
            assert _bitwise(got["compiled"][k][key], got["eager"][k][key]), f"call {k} {key}"
    first = got["compiled"][0]
    assert int(first["desc"][2].sum()) > 0 and int(first["desc"][3].sum()) > 0
    assert int(first["full"][1].sum()) > 0
    assert got["shipped"]["compiled"] == got["shipped"]["eager"]


@pytest.mark.gpu
def test_nccl_compiled_rounds_are_one_graph_and_equal_plain_twins(cuda, tmp_path):
    """At NCCL world size 1 on the card: :func:`_demo_state`'s 4 agents,
    then 3 calls of each compiled round and its plain twin from one start.
    Every call bit for bit, one graph launch per compiled call after the
    first, fewer than 10 kernel launch calls outside it, no host sync, the
    same bytes shipped (none: one rank)."""
    import dataclasses
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from x_multi_agent_torch import configs
    from x_multi_agent_torch.parallel import multihost
    from x_multi_agent_torch.utils.bench import launch_calls

    params = configs.flagship_params(small=True)
    fs, slots, db, words = _demo_state(params, cuda)
    mesh = tmesh.make_agent_mesh("nccl", f"file://{tmp_path}/nccl", 0, 1, cuda)
    try:
        ccfg = multihost.demo_ccfg(2)
        twins = {}
        for c in (True, False):
            m = dataclasses.replace(mesh, shipped={})
            twins[c] = (m, tmesh.sharded_collab_round_desc(params, ccfg, words, m, compiled=c),
                        tmesh.sharded_collab_round(params, ccfg, m, compiled=c), [fs, db])
        for k in range(N_CALLS):
            outs = {}
            for c, (m, desc, full, state) in twins.items():
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode(1)
                    try:
                        with profile(activities=[ProfilerActivity.CPU]) as prof:
                            d = desc(state[0], slots, state[1])
                            f = full(d[0])
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                state[:] = [f[0], d[1]]
                outs[c] = tree.map_leaves(torch.clone, (d, f))
                if c and k:
                    calls, graphs = launch_calls(prof)
                    assert graphs == 2 and calls < 2 * 10, (k, calls, graphs)
                    assert not [w for w in caught if "called a synchronizing" in str(w.message)]
            assert _bitwise(outs[True], outs[False]), f"call {k}"
        assert all(p.graphs.captured == 1 for p in twins[True][1:3])
        assert twins[True][0].shipped == twins[False][0].shipped
    finally:
        torch.distributed.destroy_process_group()
