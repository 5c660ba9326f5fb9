"""PyTorch port vs the JAX reference: the multi-rank agent exchange
(``parallel/mesh.py``) and its dry run (``parallel/dryrun.py``).

The port's rounds (compiled, their default; ``test_torch_mesh_graph.py``
holds them against their plain twins) run on 2 gloo ranks spawned on the
CPU (a ``file://`` init in ``tmp_path``, one thread per rank, each test
under its own time limit through ``mesh.spawn_agents``); the JAX side runs on the conftest's
virtual CPU devices in float64, the port in float64. The collective layout
(the all_to_all's split and concat axes, requester and responder
orientation, top-K gather indices, the block offset of a rank's agents) is
what a smoke test that only counts hits cannot catch, so every round is held
equal to a reference: integer and boolean leaves exactly, float leaves
within the stated share of each leaf's max.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_collab import CCFG, PARAMS
from torch_helpers import (assert_tree_close, mesh_desc_inputs, mesh_four_agents, np_tree,
                           port_params, sim_matches, t, to_port)
from x_multi_agent_tpu.parallel import mesh as jmesh
from x_multi_agent_tpu.utils.sim import make_circle_sim
from x_multi_agent_tpu.vio import pipeline as jpipe
from x_multi_agent_tpu.vio import track_manager as jtm
from x_multi_agent_tpu.vio import vio as jvio
from x_multi_agent_torch.parallel import collab as tcollab
from x_multi_agent_torch.parallel import dryrun
from x_multi_agent_torch.parallel import mesh as tmesh
from x_multi_agent_torch.utils import tree
from x_multi_agent_torch.vio import pipeline as tpipe

TP = port_params(PARAMS)
REL = 1e-8


def port_ccfg(ccfg):
    return tcollab.CollabConfig(**ccfg._asdict())


def _spawn(tmp_path, fn, *args, timeout_s=180.0):
    """``fn(mesh, *args)`` on 2 gloo ranks on the CPU; rank 0's result."""
    return tmesh.spawn_agents(fn, 2, "gloo", f"file://{tmp_path}/init", args, timeout_s,
                              device="cpu")[0]


def _stack(*xs):
    return jax.tree.map(lambda *v: jnp.stack(v), *xs)


@pytest.fixture(scope="module")
def desc_inputs():
    """The inputs of the reference's mesh-descriptor test
    (``torch_helpers.mesh_desc_inputs``)."""
    return mesh_desc_inputs()


def test_sharded_collab_round_matches_jax(tmp_path, desc_inputs):
    """The full-map round on 2 ranks against the reference's mesh round on
    2 virtual devices (the reference's two 3 s agents)."""
    fs = desc_inputs[0]
    mesh = jmesh.make_agent_mesh(jax.devices()[:2])
    ref_fs, ref_nm = jmesh.sharded_collab_round(PARAMS, CCFG, mesh)(fs)
    got = _spawn(tmp_path, dryrun.rounds_on_ranks, TP, to_port(fs), port_ccfg(CCFG))
    got_fs, got_nm = got["full"]
    np.testing.assert_array_equal(got_nm.numpy(), np.asarray(ref_nm))
    assert_tree_close(got_fs, np_tree(ref_fs), REL, "fs")
    assert int(got_nm.sum()) > 0 and int(got_nm.diagonal().sum()) == 0
    # the payload block crossed once each way
    pay_b = tcollab.payload_nbytes(tcollab.extract_payload(TP, to_port(fs)))
    assert got["shipped"] == [{"payloads": pay_b, "vlads": 0, "keyframes": 0}] * 2


def test_sharded_collab_round_desc_matches_jax(tmp_path, desc_inputs):
    """The descriptor round on 2 ranks against the reference's mesh round on
    2 virtual devices, with the RANSAC gate off (torch cannot repeat the
    reference's draws; the keyed draws are held below)."""
    fs, slots, db, words = desc_inputs
    ccfg = CCFG._replace(desc_ratio_thr=0.85, desc_abs_thr=60.0, pr_score_thr=0.05,
                         pr_ransac_thr=0.0, top_k_peers=1, ci_slam_w=0.05)
    mesh = jmesh.make_agent_mesh(jax.devices()[:2])
    ref = jmesh.sharded_collab_round_desc(PARAMS, ccfg, jnp.asarray(words), mesh)(fs, slots, db)
    got = _spawn(tmp_path, dryrun.rounds_on_ranks, TP, to_port(fs), None, port_ccfg(ccfg),
                 t(words), to_port(slots), to_port(db))
    g_fs, g_db, g_hits, g_nm = got["desc"]
    np.testing.assert_array_equal(g_hits.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(g_nm.numpy(), np.asarray(ref[3]))
    assert_tree_close(g_db, np_tree(ref[1]), 0.0, "db")
    assert_tree_close(g_fs, np_tree(ref[0]), REL, "fs")
    assert int(g_hits.sum()) > 0 and int(g_nm.sum()) > 0


@pytest.fixture(scope="module")
def four_agents(desc_inputs):
    """Four agents, two per rank (``torch_helpers.mesh_four_agents``)."""
    return mesh_four_agents(desc_inputs)


@pytest.mark.parametrize("top_k", [0, 2])
def test_sharded_rounds_match_single_process(tmp_path, four_agents, top_k):
    """Both rounds on 2 ranks of 2 agents each (the block offset) against
    the port's single-process rounds, the RANSAC gate on at the default
    ``pr_ransac_thr`` = 0.01 with the keyed draws: integers exactly, floats
    within 1e-12."""
    fs, slots, db, words = four_agents
    dccfg = port_ccfg(CCFG._replace(desc_ratio_thr=0.85, desc_abs_thr=60.0, pr_score_thr=0.05,
                                    top_k_peers=top_k))
    assert dccfg.pr_ransac_thr == 0.01
    ccfg = port_ccfg(CCFG)
    ref = dryrun.single_rounds(TP, fs, ccfg, dccfg, words, slots, db)
    got = _spawn(tmp_path, dryrun.rounds_on_ranks, TP, fs, ccfg, dccfg, words, slots, db)
    for key in ("desc", "full"):
        assert_tree_close(got[key], tree.map_leaves(lambda x: x.numpy(), ref[key]), 1e-12, key)
    hits = got["desc"][2]
    assert int(hits.sum()) > 0 and not bool(hits.diagonal().any())
    assert int(got["desc"][3].sum()) > 0 and int(got["full"][1].sum()) > 0
    if top_k:
        assert bool((hits.sum(1) <= top_k).all())
    # the bytes each collective shipped: both ranks alike, a payload block
    # and a VLAD block once each way, the keyframe grid's other half
    shipped = got["shipped"]
    assert shipped[0] == shipped[1]
    pay_b = tcollab.payload_nbytes(tcollab.extract_payload(TP, fs))
    assert shipped[0]["payloads"] == 2 * pay_b
    assert shipped[0]["vlads"] == 2 * tcollab.vlad_nbytes(words)
    kf_b = tcollab.payload_nbytes(tcollab.extract_payload_desc(TP, fs, slots)) + 1 + 4
    assert shipped[0]["keyframes"] == 2 * 2 * kf_b


def test_sharded_step_matches_jax(tmp_path):
    """One frame of sim matches through the sharded step on 2 ranks
    against the reference's on 2 virtual devices."""
    from __graft_entry__ import _params

    jp = _params(small=True)._replace(dtype="float64")
    j = jp.cfg.tracks.n_matches
    sims = [make_circle_sim(duration=0.3, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                            match_budget=j, pixel_noise=5e-4, seed=1, phase=0.15 * a,
                            lm_window=(2 * a, 2 * a + 20)) for a in range(2)]
    fs, slots = jax.vmap(lambda v: jvio.init_at_time(jp, 0.0, v=v))(
        jnp.asarray([[1.8, 0.0, 0.0], [1.7, 0.3, 0.0]]))
    sl = slice(1, 11)
    imu = [np.stack([getattr(s, k)[sl] for s in sims]) for k in ("imu_t", "imu_w", "imu_a")]
    seqs = np.broadcast_to(np.arange(1, 11, dtype=np.int32), (2, 10))
    matches = [jtm.Matches.of(track_id=jnp.asarray(s.match_id[0]),
                              prev_pt=jnp.asarray(s.match_prev[0]),
                              cur_pt=jnp.asarray(s.match_cur[0]),
                              valid=jnp.asarray(s.match_valid[0])) for s in sims]
    meas = jax.vmap(lambda m: jpipe.FrameMeasurement.from_matches(jp.cfg, m))(_stack(*matches))
    t_cam = np.full((2,), sims[0].cam_t[0])
    mesh = jmesh.make_agent_mesh(jax.devices()[:2])
    ref = jmesh.sharded_step(jp, mesh)(fs, slots, jnp.asarray(imu[0]), jnp.asarray(seqs),
                                       jnp.asarray(imu[1]), jnp.asarray(imu[2]),
                                       jnp.asarray(t_cam), meas)
    tmeas = tpipe.FrameMeasurement.from_matches(
        port_params(jp).cfg, tree.cat([sim_matches(s, 0) for s in sims]))
    got = _spawn(tmp_path, dryrun.step_on_ranks, port_params(jp), to_port(fs), to_port(slots),
                 t(imu[0]), t(seqs), t(imu[1]), t(imu[2]), t(t_cam), tmeas)
    assert_tree_close(got, np_tree(ref), REL, "step")
    assert bool(got[2].all())


def test_dryrun_multichip_passes_its_checks():
    """The dry run on 2 gloo ranks of 2 agents each (small dims, float32 on
    the CPU): the reference dry run's conditions hold."""
    rec = dryrun.dryrun_multichip(2, "gloo", 2, device="cpu", timeout_s=300.0)
    assert all(rec["checks"].values()) and rec["agents"] == 4
    assert rec["matches_fused"] > 0 and rec["desc_fused"] > 0
    assert all(rec["applied"])


@pytest.mark.gpu
def test_dryrun_multichip_on_the_card():
    """The same dry run with both gloo ranks on the card, its rounds
    compiled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec = dryrun.dryrun_multichip(2, "gloo", 2, device="cuda", timeout_s=300.0)
    assert all(rec["checks"].values()) and rec["agents"] == 4
    assert rec["matches_fused"] > 0 and rec["desc_fused"] > 0
    assert all(rec["applied"])


def test_spawn_agents_stops_ranks_past_its_limit(tmp_path):
    """Ranks that do not finish within the limit are killed and the call
    raises, well before a collective's own timeout."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        tmesh.spawn_agents(dryrun._dryrun_rank, 2, "gloo", f"file://{tmp_path}/init", (4,),
                           timeout_s=2.0, device="cpu")
    assert time.monotonic() - t0 < 30.0


def test_make_agent_mesh_refuses_nccl_on_one_device():
    """NCCL puts one rank on each device: two ranks on a CPU-only machine
    (or on one card) raise, naming gloo; the mesh never switches backends
    itself."""
    with pytest.raises(ValueError, match="gloo"):
        tmesh.make_agent_mesh("nccl", "file:///nonexistent", 0, 2, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmesh.make_agent_mesh("gloo", "file:///nonexistent", 0, 2)
