"""PyTorch port vs the JAX reference: the descriptor-driven collaboration
(REQUEST_COMM): descriptor SLAM-SLAM fusion with its three gates, the VLAD
request-response round, the joint-MSCKF CI round, the persistent match
store and the visual update's store branches, and the ``VIO`` facade's
closed request-response loop.

Agents come from short reference ``VIO`` runs built as
``tests/test_collab.py`` builds them, with descriptors from a random table
keyed by track id. JAX runs in float64 on the CPU as the rest of the suite,
the port on CPU tensors in float64; the port's RANSAC gates get the
reference's own draws (``torch_helpers.jax_keyed_sampler``). Integer and
boolean leaves (hits, served flags, fused counts, store rows, keyframes
selected) must match exactly, float leaves within 1e-8 of each leaf's max.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_collab import CCFG, DIMS, PARAMS, TRACKS, run_agent
from test_match_store import SDIMS, _empty_frame, _payload, _slots_with_opp
from torch_helpers import (assert_tree_close, jax_keyed_sampler, np_tree, port_params,
                           sim_matches, stack, t, to_port)
from x_multi_agent_tpu.parallel import collab as jcollab
from x_multi_agent_tpu.parallel import match_store as jms
from x_multi_agent_tpu.place_recognition import database as jdb
from x_multi_agent_tpu.place_recognition.vocabulary import train_kmajority
from x_multi_agent_tpu.utils.sim import make_circle_sim
from x_multi_agent_tpu.vio import track_manager as jtm
from x_multi_agent_tpu.vio import vio as jvio
from x_multi_agent_torch.parallel import collab as tcollab
from x_multi_agent_torch.parallel import match_store as tms
from x_multi_agent_torch.place_recognition import database as tdb
from x_multi_agent_torch.vio import vio as tvio

TP = port_params(PARAMS)
REL = 1e-8
SAMPLER = jax_keyed_sampler()
# the reference tests' descriptor setting (test_request_comm_loop.py:35-38)
DESC_CCFG = CCFG._replace(desc_ratio_thr=0.9, desc_abs_thr=40.0, pr_score_thr=0.2)


def port_ccfg(ccfg):
    return tcollab.CollabConfig(**ccfg._asdict())


def _stack(*xs):
    return jax.tree.map(lambda *v: jnp.stack(v), *xs)


def _row(x, i):
    return jax.tree.map(lambda v: v[i], x)


@pytest.fixture(scope="module")
def desc_table():
    return np.random.default_rng(11).integers(0, 256, (40, 32)).astype(np.uint8)


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(12)
    return train_kmajority(rng.integers(0, 256, (400, 32)).astype(np.uint8), 16, 5).words


@pytest.fixture(scope="module")
def agents(desc_table):
    """Three reference agents over one landmark field after 1.5 s (the
    second 0.25 m off under a loose prior, the third 0.1 m off), stacked:
    (fs, slots)."""
    runs = [run_agent(off, sig, duration=1.5, desc_table=desc_table)[0]
            for off, sig in (((0.0, 0.0, 0.0), 1e-3), ((0.25, 0.0, 0.0), 0.5),
                             ((0.0, 0.1, 0.0), 0.1))]
    return _stack(*[v.fs for v in runs]), _stack(*[v.slots for v in runs])


def _peer_payloads(fs, slots):
    """Each agent's peer payload: the next agent's keyframe."""
    a = fs.head.shape[0]
    pay = jax.vmap(lambda f, s: jcollab.extract_payload_desc(PARAMS, f, s))(fs, slots)
    return jax.tree.map(lambda x: x[(np.arange(a) + 1) % a], pay)


_j_fuse = jax.jit(jcollab.fuse_with_peer_desc, static_argnums=(0, 1))


# ---------------------------------------------------------------------------
# descriptor fusion and the rounds
# ---------------------------------------------------------------------------


def test_extract_payload_desc_matches_jax(agents):
    fs, slots = agents
    ref = jax.vmap(lambda f, s: jcollab.extract_payload_desc(PARAMS, f, s))(fs, slots)
    got = tcollab.extract_payload_desc(TP, to_port(fs), to_port(slots))
    assert_tree_close(got, np_tree(ref), 1e-12, "payload")
    assert bool(got.trk_desc_valid.any()) and bool(got.slam_desc_valid.any())


def test_fuse_with_peer_desc_all_gates_matches_jax(agents):
    """Epipolar RANSAC (the reference's draws), pairwise-distance
    consistency and the re-fusion cooldown all on; two receives in a row,
    the second inside the cooldown."""
    fs, slots = agents
    ccfg = DESC_CCFG._replace(geom_consistency_tol=0.2, refuse_cooldown=2)
    peer = _peer_payloads(fs, slots)
    a = fs.head.shape[0]
    nslam = slots.slam_id.shape[1]
    rec0 = (jnp.full((nslam,), -1, jnp.int32), jnp.full((nslam,), -(10**9), jnp.int32),
            jnp.asarray(0, jnp.int32))
    ref_fs, ref_n, ref_rec = [], [], []
    for i in range(a):
        f, rec, ns = _row(fs, i), rec0, []
        for _ in range(2):
            f, n, rec = _j_fuse(PARAMS, ccfg, f, _row(slots, i), _row(peer, i), True, rec)
            rec = (rec[0], rec[1], rec[2] + 1)
            ns.append(int(n))
        ref_fs.append(f)
        ref_n.append(ns)
        ref_rec.append(rec)
    p_fs, p_slots, p_peer = to_port(fs), to_port(slots), to_port(peer)
    rec = tcollab.fresh_recency(p_slots)
    ns = []
    valid = torch.ones((a,), dtype=torch.bool)
    for _ in range(2):
        p_fs, n, rec = tcollab.fuse_with_peer_desc(TP, port_ccfg(ccfg), p_fs, p_slots, p_peer,
                                                   valid, recency=rec, sampler=SAMPLER)
        rec = (rec[0], rec[1], rec[2] + 1)
        ns.append(n.tolist())
    np.testing.assert_array_equal(np.array(ns).T, np.array(ref_n))
    assert_tree_close(p_fs, np_tree(_stack(*ref_fs)), REL, "fs")
    for g, r in zip(rec, zip(*ref_rec)):
        np.testing.assert_array_equal(g.numpy(), np.stack([np.asarray(x) for x in r]))
    first, second = np.array(ref_n).T
    assert first.sum() > 0 and second.sum() < first.sum()


def _dbs(fs, slots, words):
    """Every agent's keyframe ring holding two keyframes: its own current
    snapshot and its next peer's."""
    dd = jdb.DbDims(n_keyframes=3, n_words=words.shape[0], max_agents=4)
    own = jax.vmap(lambda f, s: jcollab.extract_payload_desc(PARAMS, f, s))(fs, slots)
    peer = _peer_payloads(fs, slots)
    w = jnp.asarray(words)

    def one(o, p):
        db = jdb.KeyframeDB.zero(dd, o)
        return jdb.add_keyframe(dd, jdb.add_keyframe(dd, db, o, w), p, w)

    return dd, jax.vmap(one)(own, peer)


@pytest.mark.parametrize("top_k", [0, 1])
def test_request_response_round_matches_jax(agents, words, top_k):
    fs, slots = agents
    ccfg = DESC_CCFG._replace(top_k_peers=top_k)
    _, db = _dbs(fs, slots, words)
    ref = jax.jit(jcollab.request_response_round, static_argnums=(0, 1))(
        PARAMS, ccfg, jnp.asarray(words), fs, slots, db)
    got = tcollab.request_response_round(TP, port_ccfg(ccfg), t(words), to_port(fs),
                                         to_port(slots), to_port(db), sampler=SAMPLER)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))  # hits
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))  # fused per peer
    assert_tree_close(got[1], np_tree(ref[1]), 0.0, "db")
    assert_tree_close(got[0], np_tree(ref[0]), REL, "fs")
    hits = got[2].numpy()
    assert hits.any() and not hits.diagonal().any() and int(got[3].sum()) > 0
    if top_k:
        assert (hits.sum(1) <= top_k).all()


@pytest.mark.parametrize("k", [0, 1, 2, 5])
def test_top_k_select_ties_match_jax(k):
    """Equal scores keep the lower responder first (the reference's stable
    argsort); misses rank last whatever their score; k <= 0 or k >= P keeps
    every responder."""
    hits = np.array([[True, True, False, True], [False, True, True, True], [False] * 4])
    scores = np.array([[0.5, 0.5, 0.9, 0.5], [0.7, 0.4, 0.4, 0.7], [0.3] * 4], np.float32)
    ref = jcollab.top_k_select(jnp.asarray(hits), jnp.asarray(scores), k)
    got = tcollab.top_k_select(t(hits), t(scores), k)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_request_response_round_raises_past_the_served_bitmap(agents, words):
    fs, slots = agents
    dd, db = _dbs(fs, slots, words)
    narrow = to_port(db)
    narrow = dataclasses.replace(narrow, served=narrow.served[..., :2])
    with pytest.raises(ValueError, match="served bitmap"):
        tcollab.request_response_round(TP, port_ccfg(DESC_CCFG), t(words), to_port(fs),
                                       to_port(slots), narrow, sampler=SAMPLER)


@pytest.mark.parametrize("w", [0.01, 0.05])
def test_collaborative_msckf_round_matches_jax(agents, w):
    """The round at the reference's default CI weight and at 0.05."""
    fs, slots = agents
    ccfg = CCFG._replace(ci_msckf_w=w, desc_abs_thr=40.0, max_peers=2)
    ref_fs, ref_n = jax.jit(jcollab.collaborative_msckf_round, static_argnums=(0, 1))(
        PARAMS, ccfg, fs, slots)
    got_fs, got_n = tcollab.collaborative_msckf_round(TP, port_ccfg(ccfg), to_port(fs),
                                                      to_port(slots))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    assert_tree_close(got_fs, np_tree(ref_fs), REL, "fs")
    assert int(got_n.sum()) > 0


@pytest.mark.parametrize("w", [0.05, -0.05])
def test_apply_joint_msckf_ci_matches_jax(agents, w):
    """Descriptor association and the joint CI update of each agent's
    collaborative tracks against its two peers' sets, with fixed weights and
    with the on-device weight optimization (w < 0), on each agent's
    covariance plus 1e-4 I: the optimization inverts the covariance, and the
    filter's own (unused feature slots at zero) has no inverse to compare."""
    from x_multi_agent_tpu.ekf import buffer as jrb
    from x_multi_agent_tpu.vio.updates import msckf_multi as jmm
    from x_multi_agent_torch.vio.updates import msckf_multi as tmm

    fs, slots = agents
    a = fs.head.shape[0]
    pay = jax.vmap(lambda f, s: jcollab.extract_payload_desc(PARAMS, f, s))(fs, slots)
    peer_ids = np.array([[(i + 1) % a, (i + 2) % a] for i in range(a)])
    peer = jax.tree.map(lambda x: x[peer_ids], pay)
    peer = dataclasses.replace(peer, pose_cov=peer.pose_cov + 1e-4 * jnp.eye(6 * DIMS.n_poses))
    core = jax.vmap(lambda f: jrb.get_slot(f.buffer, f.head))(fs)
    cov = fs.cov + 1e-4 * jnp.eye(fs.cov.shape[-1])
    # optimized weights drive w_own toward its floor from the fourth track on
    # (w_result ~ 1e3 inflates the covariance, and float64 rounding with it):
    # that path fuses the first three tracks only
    k = 3 if w < 0 else pay.trk_obs.shape[1]
    args = tuple(x[:, :k] for x in (pay.trk_obs, pay.trk_mask, pay.trk_desc_valid,
                                    pay.trk_desc, pay.trk_desc_valid)) + (
        peer.p_arr, peer.q_arr, peer.pose_cov, peer.trk_obs, peer.trk_mask, peer.trk_desc,
        peer.trk_desc_valid, jnp.ones((a, 2), bool))
    ref = jax.jit(jax.vmap(lambda c, v, p, *x: jmm.apply_joint_msckf_ci(
        DIMS, c, v, p, *x, PARAMS.cfg.sigma_img, w, oc=False, desc_abs_thr=40.0)))(
        core, fs.vision, cov, *args)
    got = tmm.apply_joint_msckf_ci(
        TP.cfg.dims, to_port(core), to_port(fs.vision), t(cov),
        *[t(x) if isinstance(x, jnp.ndarray) else x for x in args],
        PARAMS.cfg.sigma_img, w, oc=False, desc_abs_thr=40.0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for name, g, r in zip(("core", "vision", "cov"), got[:3], ref[:3]):
        assert_tree_close(g, np_tree(r), REL, name)
    assert int(got[3].sum()) > 0


# ---------------------------------------------------------------------------
# the match store
# ---------------------------------------------------------------------------


def _store_inputs(rng):
    """Two agents' opportunistic tracks and payloads (tests/test_match_store
    helpers): agent 0 as ``test_upgrade_and_discard`` sets it up, agent 1
    with duplicated peer descriptors (a kNN tie)."""
    per_slots, per_pay, per_opp = [], [], []
    for i in range(2):
        slots, opp_desc = _slots_with_opp(rng, n_opp_active=4)
        collab_desc = rng.integers(0, 256, (4, 32)).astype(np.uint8)
        slam_desc = rng.integers(0, 256, (TRACKS.n_slam, 32)).astype(np.uint8)
        collab_desc[0] = opp_desc[0]
        collab_desc[1] = opp_desc[2]
        slam_desc[3] = opp_desc[1]
        collab_desc[2] = opp_desc[3]
        if i == 1:
            collab_desc[3] = opp_desc[0]  # tie with collab track 0
        pay = _payload(rng, collab_desc, slam_desc)
        pay = dataclasses.replace(pay, time=jnp.asarray(1.0 + 0.5 * i),
                                  slam_obs=jnp.asarray(rng.normal(size=(TRACKS.n_slam, 2)) * 0.1))
        slots = dataclasses.replace(slots, opp_obs=jnp.asarray(
            rng.normal(size=slots.opp_obs.shape) * 0.1))
        per_slots.append(slots)
        per_pay.append(pay)
    return _stack(*per_slots), _stack(*per_pay)


@pytest.mark.parametrize("ransac_thr", [0.0, 0.05])
def test_record_and_dedup_matches_jax(ransac_thr):
    slots, pay = _store_inputs(np.random.default_rng(0))
    jstore = _stack(*[jms.MatchStore.zero(DIMS, SDIMS, n_collab_tracks=4, dtype=jnp.float64)] * 2)
    tstore = tms.MatchStore.zero(DIMS, tms.StoreDims(*SDIMS), 2, n_collab_tracks=4,
                                 dtype=torch.float64)
    assert_tree_close(tstore, np_tree(jstore), 0.0, "zero")
    uav = np.array([7, 3], np.int32)
    when = np.array([True, True])
    for step in range(3):  # the third receive overwrites ring slot 0
        if step == 2:
            when = np.array([True, False])
        jstore = jax.vmap(lambda s, sl, p, u, w: jms.record(
            s, sl, p, u, 0.8, 60.0, store_when=w, ransac_thr=ransac_thr))(
            jstore, slots, pay, jnp.asarray(uav), jnp.asarray(when))
        tstore = tms.record(tstore, to_port(slots), to_port(pay), t(uav), 0.8, 60.0,
                            store_when=t(when), ransac_thr=ransac_thr, sampler=SAMPLER)
        assert_tree_close(tstore, np_tree(jstore), 0.0, f"store[{step}]")
    assert int((tstore.own_id >= 0).sum()) >= 4


def test_record_gt_and_harvest_match_jax():
    """Id-equality classification, then the upgrade/discard join of
    ``test_upgrade_and_discard``: own 100 selected as MSCKF, 101 promoted
    to SLAM slot 2, 103 died, 102 stays opportunistic."""
    rng = np.random.default_rng(1)
    slots, pay = _store_inputs(rng)
    trk_id = np.full((2, 4), -1, np.int32)
    trk_id[:, 0], trk_id[:, 1], trk_id[0, 2] = 100, 102, 103
    slam_id = np.full((2, TRACKS.n_slam), -1, np.int32)
    slam_id[:, 3] = 101
    slam_id[1, 5] = 102  # also a SLAM feature: the collaborative match wins
    pay = dataclasses.replace(pay, trk_id=jnp.asarray(trk_id), slam_id=jnp.asarray(slam_id))
    jstore = _stack(*[jms.MatchStore.zero(DIMS, SDIMS, n_collab_tracks=4, dtype=jnp.float64)] * 2)
    jstore = jax.vmap(lambda s, sl, p: jms.record_gt(s, sl, p, 7))(jstore, slots, pay)
    tstore = tms.record_gt(tms.MatchStore.zero(DIMS, tms.StoreDims(*SDIMS), 2, 4, torch.float64),
                           to_port(slots), to_port(pay), 7)
    assert_tree_close(tstore, np_tree(jstore), 0.0, "record_gt")

    frame = _empty_frame()
    frame = dataclasses.replace(frame, msckf_id=frame.msckf_id.at[0].set(100),
                                msckf_valid=frame.msckf_valid.at[0].set(True),
                                short_id=frame.short_id.at[1].set(103),
                                short_valid=frame.short_valid.at[1].set(True))
    own_slam = np.array(slots.slam_id)
    own_slam[:, 2] = 101
    opp_id = np.array(slots.opp_id)
    opp_id[np.isin(opp_id, [100, 101, 103])] = -1
    slots2 = dataclasses.replace(slots, slam_id=jnp.asarray(own_slam), opp_id=jnp.asarray(opp_id))
    frames = stack(frame, 2)
    ref_store, ref_work = jax.vmap(lambda s, sl, f: jms.update_and_harvest(s, sl, f, 2))(
        jstore, slots2, frames)
    got_store, got_work = tms.update_and_harvest(tstore, to_port(slots2), to_port(frames), 2)
    assert_tree_close(got_store, np_tree(ref_store), 0.0, "store")
    assert_tree_close(got_work, np_tree(ref_work), 0.0, "work")
    assert bool(got_work.msckf_matched[:, 0, 0].all()) and bool(got_work.slam_matched.any())
    assert bool(got_work.short_matched[0, 1, 0])
    # the gathers feeding the joint updates
    for name, fn in (("tracks", lambda m, s, w: m.gather_peer_tracks(s, w.msckf_rows,
                                                                     w.msckf_matched)),
                     ("slam", lambda m, s, w: m.gather_peer_slam(s, w))):
        ref = jax.vmap(lambda s, w: fn(jms, s, w))(ref_store, ref_work)
        got = fn(tms, got_store, got_work)
        assert_tree_close(tuple(got), tuple(np_tree(ref)), 0.0, name)


def test_gather_peer_tracks_clamps_a_slam_row_like_jax():
    """Unmatched entries read match row 0; when that row holds a SLAM-SLAM
    match, its peer index points past the collaborative track slots. The
    gather clamps it there, as the reference's gather does, and masks it."""
    slots, pay = _store_inputs(np.random.default_rng(2))
    jstore = _stack(*[jms.MatchStore.zero(DIMS, SDIMS, n_collab_tracks=4, dtype=jnp.float64)] * 2)
    jstore = jax.vmap(lambda s, sl, p: jms.record_gt(s, sl, p, 7))(jstore, slots, pay)
    jstore = dataclasses.replace(
        jstore, own_id=jstore.own_id.at[:, 0].set(100),
        peer_type=jstore.peer_type.at[:, 0].set(jms.PEER_SLAM),
        peer_idx=jstore.peer_idx.at[:, 0].set(TRACKS.n_slam - 1))
    rows = np.full((2, 3, SDIMS.max_peers), -1, np.int32)
    rows[0, 1, 0] = 0  # one matched entry on the SLAM row itself
    matched = rows >= 0
    ref = jax.vmap(jms.gather_peer_tracks)(jstore, jnp.asarray(rows), jnp.asarray(matched))
    got = tms.gather_peer_tracks(to_port(jstore), t(rows), t(matched))
    assert_tree_close(tuple(got), tuple(np_tree(ref)), 0.0, "tracks")


@pytest.fixture(scope="module")
def store_run(desc_table):
    """B records against A's keyframe (matches persist in the store), then
    both packages run B's next frames through the store-aware visual
    update (``tests/test_match_store.py:test_two_agent_store_roundtrip``,
    shortened)."""
    va, sim = run_agent((0.0, 0.0, 0.0), 1e-3, duration=1.5, desc_table=desc_table)
    vb, _ = run_agent((0.25, 0.0, 0.0), 0.5, duration=1.5, desc_table=desc_table)
    ccfg = CCFG._replace(ci_msckf_w=0.05, ci_slam_w=0.01, desc_abs_thr=40.0, max_peers=1)
    sdims = jms.StoreDims(n_payloads=2, n_matches=16, max_peers=1)
    jstore = jms.MatchStore.zero(DIMS, sdims, n_collab_tracks=8, dtype=jnp.float64)
    pay_a = jcollab.extract_payload_desc(PARAMS, va.fs, va.slots)
    j_fs, jstore, j_n, _ = jcollab.receive_and_record_jit(PARAMS, ccfg, vb.fs, vb.slots, jstore,
                                                          pay_a, 0)
    t_fs, tstore, t_n, _ = tcollab.receive_and_record(
        TP, port_ccfg(ccfg), to_port(stack(vb.fs, 1)), to_port(stack(vb.slots, 1)),
        tms.MatchStore.zero(DIMS, tms.StoreDims(*sdims), 1, 8, torch.float64),
        to_port(stack(pay_a, 1)), 0, sampler=SAMPLER)
    rec = [(int(j_n), int(t_n[0]), np_tree(stack(j_fs, 1)), t_fs, np_tree(stack(jstore, 1)), tstore)]
    sim2 = make_circle_sim(duration=sim.cam_t[-1] + 1.0, imu_rate=100.0, cam_rate=10.0,
                           n_landmarks=30, match_budget=TRACKS.n_matches, pixel_noise=5e-4,
                           seed=1)
    from x_multi_agent_tpu.vio import pipeline as jpipe
    from x_multi_agent_tpu.ekf import ekf as jekf
    from x_multi_agent_torch.ekf import ekf as tekf
    from x_multi_agent_torch.vio import pipeline as tpipe
    j_slots, t_slots = vb.slots, to_port(stack(vb.slots, 1))
    t0 = sim.cam_t[-1]
    imu_i = int(np.searchsorted(sim2.imu_t, t0 + 1e-9, side="right"))
    for f, t_cam in enumerate(sim2.cam_t):
        if t_cam <= t0 + 1e-9:
            continue
        lo = imu_i
        while imu_i < len(sim2.imu_t) and sim2.imu_t[imu_i] <= t_cam + 1e-9:
            imu_i += 1
        sl = slice(lo, imu_i)
        j_fs = jekf.process_imu_batch(PARAMS.ekf_params, j_fs, *map(jnp.asarray, (
            sim2.imu_t[sl], np.arange(lo, imu_i), sim2.imu_w[sl], sim2.imu_a[sl])))
        t_fs = tekf.process_imu_batch_impl(TP.ekf_params, t_fs, t(sim2.imu_t[sl])[None],
                                           t(np.arange(lo, imu_i))[None], t(sim2.imu_w[sl])[None],
                                           t(sim2.imu_a[sl])[None])
        ids = np.clip(sim2.match_id[f], 0, len(desc_table) - 1)
        jm = jtm.Matches.of(track_id=jnp.asarray(sim2.match_id[f]),
                            prev_pt=jnp.asarray(sim2.match_prev[f]),
                            cur_pt=jnp.asarray(sim2.match_cur[f]),
                            valid=jnp.asarray(sim2.match_valid[f]),
                            desc=jnp.asarray(desc_table[ids]),
                            desc_valid=jnp.asarray(sim2.match_valid[f]))
        tm_ = dataclasses.replace(sim_matches(sim2, f), desc=t(desc_table[ids])[None],
                                  desc_valid=t(sim2.match_valid[f])[None])
        j_fs, (j_slots, jstore, j_nc), _ = jcollab.visual_update_with_store_jit(
            PARAMS, ccfg, j_fs, j_slots, jstore, t_cam, jpipe.FrameMeasurement.from_matches(
                PARAMS.cfg, jm))
        t_fs, (t_slots, tstore, t_nc), _ = tcollab.visual_update_with_store(
            TP, port_ccfg(ccfg), t_fs, t_slots, tstore, t([t_cam]),
            tpipe.FrameMeasurement.from_matches(TP.cfg, tm_))
        rec.append((int(j_nc), int(t_nc[0]), np_tree(stack(j_fs, 1)), t_fs,
                    np_tree(stack(jstore, 1)), tstore))
    return rec


def test_receive_and_record_matches_jax(store_run):
    j_n, t_n, j_fs, t_fs, j_store, t_store = store_run[0]
    assert j_n == t_n
    assert_tree_close(t_fs, j_fs, REL, "fs")
    assert_tree_close(t_store, j_store, REL, "store")
    assert int((t_store.own_id >= 0).sum()) > 0, "no matches recorded"


def test_visual_update_store_branches_match_jax(store_run):
    """Frame by frame: the consumed-match count, the state and the store."""
    for k, (j_n, t_n, j_fs, t_fs, j_store, t_store) in enumerate(store_run[1:]):
        assert j_n == t_n, k
        assert_tree_close(t_fs, j_fs, REL, f"fs[{k}]")
        assert_tree_close(t_store, j_store, REL, f"store[{k}]")
    assert sum(r[1] for r in store_run[1:]) > 0, "stored matches were never consumed"


# ---------------------------------------------------------------------------
# the facade's closed loop
# ---------------------------------------------------------------------------


def _closed_loop(n_frames, words, port_only=False, duration=None):
    """Two facades per package (agent 1 offset under a loose prior) on
    ``make_circle_sim``, an exchange every 3 frames as
    ``tests/test_request_comm_loop.py`` runs it. Returns the per-exchange
    record, the port's facades and the sims."""
    rng = np.random.default_rng(0)
    desc_table = rng.integers(0, 256, (40, 32)).astype(np.uint8)
    dur = duration if duration is not None else n_frames / 10.0
    sims = [make_circle_sim(duration=dur, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                            match_budget=TRACKS.n_matches, pixel_noise=5e-4, seed=1)] * 2
    ccfg = CCFG._replace(sigma_landmark=0.02, ci_slam_w=0.5, match_budget=8,
                         desc_ratio_thr=0.9, desc_abs_thr=40.0, pr_score_thr=0.2)
    packs = [("port", tvio, port_params)] + ([] if port_only else [("jax", jvio, None)])
    fac = {}
    for name, mod, conv in packs:
        fac[name] = []
        for uav, (off, sig) in enumerate((((0.0, 0.0, 0.0), 1e-3), ((0.25, 0.0, 0.0), 0.5))):
            params = PARAMS._replace(sigma_dp=(sig,) * 3)
            v = mod.VIO(conv(params) if conv else params)
            v.init_at_time(0.0, p=np.asarray(off), v=np.array([1.8, 0.0, 0.0]))
            v.enable_collab(words, uav_id=uav, ccfg=port_ccfg(ccfg) if conv else ccfg)
            if conv:
                v.sampler = SAMPLER
            fac[name].append(v)
    payload_b = tcollab.payload_nbytes(fac["port"][0].get_data_to_send())
    vlad_b = tcollab.vlad_nbytes(t(words))
    bytes_rr = bytes_full = 0
    imu_i = 0
    rec = []
    for f in range(min(n_frames, len(sims[0].cam_t))):
        sim = sims[0]
        lo = imu_i
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= sim.cam_t[f] + 1e-9:
            imu_i += 1
        ids = sim.match_id[f]
        desc = desc_table[np.clip(ids, 0, 39)]
        for name, vs in fac.items():
            for v in vs:
                for i in range(lo, imu_i):
                    v.process_imu(sim.imu_t[i], i, sim.imu_w[i], sim.imu_a[i])
                if name == "port":
                    m = dataclasses.replace(sim_matches(sim, f), desc=t(desc)[None],
                                            desc_valid=t(sim.match_valid[f])[None])
                else:
                    m = jtm.Matches.of(track_id=jnp.asarray(ids),
                                       prev_pt=jnp.asarray(sim.match_prev[f]),
                                       cur_pt=jnp.asarray(sim.match_cur[f]),
                                       valid=jnp.asarray(sim.match_valid[f]),
                                       desc=jnp.asarray(desc),
                                       desc_valid=jnp.asarray(sim.match_valid[f]))
                v.process_matches_measurement(sim.cam_t[f], f, m)
        bytes_full += 2 * payload_b
        if f % 3 != 2:
            continue
        ex = {}
        for name, vs in fac.items():
            hits, fused = [], []
            for req in range(2):
                res = 1 - req
                payload, found = vs[res].process_other_requests(req, vs[req].get_descriptors())
                hits.append(found)
                fused.append(vs[req].process_other_measurements(payload, uav_id=res)
                             if found else 0)
            ex[name] = (hits, fused, [v.n_keyframes_selected for v in vs],
                        [v.fs for v in vs])
        bytes_rr += 2 * vlad_b + sum(ex["port"][0]) * payload_b
        rec.append((f, ex))
    return rec, fac["port"], sims, bytes_rr, bytes_full


def test_facade_closed_loop_matches_jax(words):
    """18 frames of the two-agent loop; at every exchange (every 3rd frame)
    the hits, fused counts and keyframes selected exactly, the states
    within 1e-8."""
    rec, port, _, _, _ = _closed_loop(18, words)
    for f, ex in rec:
        ph, pf, pk, pfs = ex["port"]
        jh, jf, jk, jfs = ex["jax"]
        assert (ph, pf, pk) == (jh, jf, jk), f
        for i in range(2):
            assert_tree_close(pfs[i], np_tree(stack(jfs[i], 1)), REL, f"fs[{f}][{i}]")
    assert port[0].n_keyframes_selected >= 1
    assert any(any(ex["port"][0]) for _, ex in rec), "no hit"
    assert sum(sum(ex["port"][1]) for _, ex in rec) > 0, "no match fused"


@pytest.mark.slow
def test_request_comm_closed_loop_port_only(words):
    """The port alone through ``tests/test_request_comm_loop.py``'s 5 s run
    and asserts: keyframes selected, hits, fused matches, > 85 % bandwidth
    saving against full broadcast, the degraded agent within 0.25 m."""
    rng = np.random.default_rng(0)
    rng.integers(0, 256, (40, 32))  # the descriptor table, drawn first as there
    words16 = train_kmajority(rng.integers(0, 256, (400, 32)).astype(np.uint8), 16, 5).words
    rec, port, sims, bytes_rr, bytes_full = _closed_loop(10**6, words16, port_only=True,
                                                         duration=5.0)
    assert port[0].n_keyframes_selected >= 1
    assert sum(sum(ex["port"][0]) for _, ex in rec) >= 1
    assert sum(sum(ex["port"][1]) for _, ex in rec) >= 1
    assert 1.0 - bytes_rr / bytes_full > 0.85
    err = np.linalg.norm(port[1].tail_state().p[0].numpy() - sims[1].cam_p[-1])
    assert err < 0.25, err
