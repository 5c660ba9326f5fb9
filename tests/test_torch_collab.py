"""PyTorch port vs the JAX reference: the collaborative SLAM-SLAM exchange
(covariance intersection, ground-truth landmark matching, the joint and
sequential CI updates, payloads, the full-map round).

Inputs come from a numpy seed or from a short reference ``VIO`` run of two
agents built as ``tests/test_collab.py`` builds them (1.5 s instead of 3 s);
JAX runs in float64 on the CPU as the rest of the suite, the port on CPU
tensors in float64. Integer and boolean leaves (match indices, masks, the
(A, A) fused counts) must match exactly; float leaves to the stated
tolerance of each leaf's max (the two packages sum in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_collab import CCFG, PARAMS, run_agent
from torch_helpers import assert_tree_close, np_tree, port_params, t, to_port
from x_multi_agent_tpu.ekf import buffer as jrb
from x_multi_agent_tpu.ekf import ci as jci
from x_multi_agent_tpu.parallel import collab as jcollab
from x_multi_agent_tpu.parallel import payload as jpay
from x_multi_agent_tpu.place_recognition import gt_matching as jgt
from x_multi_agent_tpu.vio.updates import multi_slam as jms
from x_multi_agent_torch.ekf import ci as tci
from x_multi_agent_torch.parallel import collab as tcollab
from x_multi_agent_torch.place_recognition import gt_matching as tgt
from x_multi_agent_torch.vio.updates import multi_slam as tms

DIMS = PARAMS.cfg.dims
TP = port_params(PARAMS)
TCCFG = tcollab.CollabConfig(**{f: getattr(CCFG, f) for f in tcollab.CollabConfig._fields})


def _spd(rng, b, d, scale=1.0):
    x = rng.normal(size=(b, d, d))
    return scale * (x @ x.transpose(0, 2, 1) + d * np.eye(d))


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rel * np.max(np.abs(ref)))


# ---------------------------------------------------------------------------
# covariance intersection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [0.05, -1.0])
def test_fuse_pairwise_matches_jax(w):
    """Fixed weight and the golden-section search (w < 0)."""
    rng = np.random.default_rng(0)
    b, d, r = 3, 12, 3
    cov_a, cov_b = _spd(rng, b, d, 0.1), _spd(rng, b, d, 0.2)
    h_a, h_b = rng.normal(size=(b, r, d)), rng.normal(size=(b, r, d))
    ref = jax.vmap(lambda *x: jci.fuse_pairwise(*x, w))(*map(jnp.asarray, (cov_a, h_a, cov_b, h_b)))
    got = tci.fuse_pairwise(*map(t, (cov_a, h_a, cov_b, h_b)), w)
    _close(got[0], ref[0], 1e-12)
    _close(got[1], ref[1], 1e-12)
    if w < 0:  # the search moved off the bounds
        assert 0.01 < float(got[1].min()) and float(got[1].max()) < 1e3


@pytest.mark.parametrize("case", ["valid", "invalid_peer", "fallback"])
def test_optimize_weights_nway_matches_jax(case):
    rng = np.random.default_rng(1)
    r, k = 4, 3
    m_own = _spd(rng, 1, r)[0]
    m_oth = _spd(rng, k, r, 0.5)
    valid = np.array([True, case != "invalid_peer", True])
    if case == "fallback":  # non-finite input -> the reference's fixed weights
        m_own = np.full((r, r), np.nan)
    ref = jci.optimize_weights_nway(jnp.asarray(m_own), jnp.asarray(m_oth), jnp.asarray(valid), 0.01)
    got = tci.optimize_weights_nway(t(m_own), t(m_oth), t(valid), 0.01)
    _close(got, ref, 1e-12)
    if case == "fallback":
        np.testing.assert_array_equal(got.numpy(), [0.97, 0.01, 0.01, 0.01])
    if case == "invalid_peer":
        assert float(got[2]) == 0.0


def test_fuse_nway_and_apply_ci_match_jax():
    rng = np.random.default_rng(2)
    b, d, do, r, k = 2, 10, 6, 3, 3
    cov_own, covs = _spd(rng, b, d, 0.1), _spd(rng, b * k, do, 0.1).reshape(b, k, do, do)
    h_own, hs = rng.normal(size=(b, r, d)), rng.normal(size=(b, k, r, do))
    valid = np.array([[True, False, True], [False, False, True]])
    ref = jax.vmap(lambda *x: jci.fuse_nway(*x, 0.05))(
        *map(jnp.asarray, (cov_own, h_own, covs, hs, valid)))
    got = tci.fuse_nway(*map(t, (cov_own, h_own, covs, hs, valid)), 0.05)
    _close(got[0], ref[0], 1e-12)
    _close(got[1], ref[1], 1e-12)
    ci_cov, res = 1.3 * cov_own, rng.normal(size=(b, r))
    ref = jax.vmap(jci.apply_ci)(*map(jnp.asarray, (cov_own, ci_cov, h_own, res, np.asarray(ref[0]))))
    got = tci.apply_ci(*map(t, (cov_own, ci_cov, h_own, res)), got[0])
    _close(got[0], ref[0], 1e-10)
    _close(got[1], ref[1], 1e-10)


# ---------------------------------------------------------------------------
# ground-truth matching
# ---------------------------------------------------------------------------


def test_match_landmarks_matches_jax():
    """Shuffled near-copies, exact ties (a duplicated peer landmark), an
    agent with no valid peer landmark (every argmin ties at index 0) and
    invalid own rows; budget below N."""
    rng = np.random.default_rng(3)
    a, n, budget = 3, 8, 6
    own = rng.normal(size=(a, n, 3)) * 3
    other = own[:, rng.permutation(n)] + rng.normal(size=(a, n, 3)) * 0.05
    other[0, 5] = other[0, 2]  # exact tie for whichever own landmark is nearest
    own_valid = rng.random((a, n)) > 0.2
    other_valid = np.ones((a, n), bool)
    other_valid[2] = False
    ref = jax.vmap(lambda *x: jgt.match_landmarks(*x, 0.3, budget))(
        *map(jnp.asarray, (own, own_valid, other, other_valid)))
    got = tgt.match_landmarks(*map(t, (own, own_valid, other, other_valid)), 0.3, budget)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[2][:2].sum() > 0 and not got[2][2].any()


# ---------------------------------------------------------------------------
# state from a short reference run: payloads, CI updates, the round
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def agents():
    """Two reference agents over one landmark field (B 0.25 m off under a
    loose prior), stacked: agent 0 well initialized, agent 1 degraded."""
    va, _ = run_agent((0.0, 0.0, 0.0), 1e-3, duration=1.5)
    vb, _ = run_agent((0.25, 0.0, 0.0), 0.5, duration=1.5)
    return jax.tree.map(lambda x, y: jnp.stack([x, y]), va.fs, vb.fs)


def _payloads(fs):
    return jax.vmap(lambda f: jcollab.extract_payload(PARAMS, f))(fs)


def test_make_payload_matches_jax(agents):
    ref = _payloads(agents)
    got = tcollab.extract_payload(TP, to_port(agents))
    assert_tree_close(got, np_tree(ref), 1e-12, "payload")
    # the state the port converts from a reference payload is the same
    assert_tree_close(to_port(ref), np_tree(ref), 0.0, "converted")
    assert tcollab.payload_nbytes(got) == jcollab.payload_nbytes(jax.tree.map(lambda x: x[0], ref))
    assert bool(got.landmark_valid.any())


def _round_matches(fs, pay):
    """Each agent against the other's payload: the round's match lists."""
    peer = jax.tree.map(lambda x: x[::-1], pay)
    own_lm, own_valid = jax.vmap(lambda v: jpay.slam_landmarks_world(DIMS, v))(fs.vision)
    return peer, jax.vmap(lambda *x: jgt.match_landmarks(*x, CCFG.gt_match_dist, CCFG.match_budget))(
        own_lm, own_valid, peer.landmarks, peer.landmark_valid)


def _head_core(fs):
    return jax.vmap(lambda f: jrb.get_slot(f.buffer, f.head))(fs)


def _shared_anchor_pair(fs, own_idx, mvalid):
    """Per agent, two kept matches whose own features share an anchor pose,
    first in the budget: the CI scale of both must be applied once."""
    out = []
    for i in range(2):
        anc = np.asarray(fs.vision.anchor_idx[i])[np.asarray(own_idx[i])]
        ok = np.asarray(mvalid[i])
        pair = next((j, k) for j in range(len(anc)) for k in range(j + 1, len(anc))
                    if ok[j] and ok[k] and anc[j] == anc[k])
        out.append(pair)
    return out


@pytest.mark.parametrize("w", [CCFG.ci_slam_w, -CCFG.ci_slam_w])
def test_apply_matches_matches_jax(agents, w):
    fs = agents
    pay = _payloads(fs)
    peer, (own_idx, other_idx, mvalid) = _round_matches(fs, pay)
    # put two matches on one anchor pose first in each agent's list
    for i, (j, k) in enumerate(_shared_anchor_pair(fs, own_idx, mvalid)):
        order = np.r_[[j, k], np.delete(np.arange(own_idx.shape[1]), [j, k])]
        own_idx = own_idx.at[i].set(own_idx[i][order])
        other_idx = other_idx.at[i].set(other_idx[i][order])
        mvalid = mvalid.at[i].set(mvalid[i][order])
    mvalid = mvalid.at[:, -1].set(False)

    def ref_one(core, vision, cov, *x):
        return jms.apply_matches(DIMS, core, vision, cov, *x, CCFG.sigma_landmark, w)

    core = _head_core(fs)
    ref = jax.jit(jax.vmap(ref_one))(core, fs.vision, fs.cov, peer.p_arr, peer.q_arr,
                                      peer.f_arr, peer.anchor_idx, peer.lm_cov, own_idx,
                                      other_idx, mvalid)
    p_fs, p_peer = to_port(fs), to_port(peer)
    got = tms.apply_matches(
        TP.cfg.dims, to_port(core), p_fs.vision, p_fs.cov, p_peer.p_arr, p_peer.q_arr,
        p_peer.f_arr, p_peer.anchor_idx, p_peer.lm_cov, t(own_idx), t(other_idx), t(mvalid),
        CCFG.sigma_landmark, w,
    )
    for name, g, r in zip(("core", "vision", "cov", "n_app", "keep"), got, ref):
        assert_tree_close(g, np_tree(r), 1e-9, name)
    n_app = got[3].numpy()
    if w > 0:
        assert (n_app >= 2).all() and got[4][:, :2].all()
    assert n_app.sum() > 0


@pytest.mark.parametrize("w", [CCFG.ci_slam_w, -CCFG.ci_slam_w])
def test_apply_matches_pairs_matches_jax(agents, w):
    """Sequential fusion, each match against its own peer snapshot (the
    other agent's payload, then the agent's own, alternating)."""
    fs = agents
    pay = _payloads(fs)
    peer, (own_idx, other_idx, mvalid) = _round_matches(fs, pay)
    k = own_idx.shape[1]
    src = np.array([[1 - i if j % 2 == 0 else i for j in range(k)] for i in range(2)])  # (A, K)
    per = jax.tree.map(lambda x: x[src], pay)  # (A, K, ...)
    core = _head_core(fs)

    def ref_one(core, vision, cov, *x):
        return jms.apply_matches_pairs(DIMS, core, vision, cov, *x, CCFG.sigma_landmark, w)

    ref = jax.jit(jax.vmap(ref_one))(core, fs.vision, fs.cov, per.p_arr, per.q_arr, per.f_arr,
                                     per.anchor_idx, per.lm_cov, own_idx, other_idx, mvalid)
    p_fs, p_per = to_port(fs), to_port(per)
    got = tms.apply_matches_pairs(
        TP.cfg.dims, to_port(core), p_fs.vision, p_fs.cov, p_per.p_arr, p_per.q_arr,
        p_per.f_arr, p_per.anchor_idx, p_per.lm_cov, t(own_idx), t(other_idx), t(mvalid),
        CCFG.sigma_landmark, w,
    )
    for name, g, r in zip(("core", "vision", "cov", "n_app", "applied"), got, ref):
        assert_tree_close(g, np_tree(r), 1e-9, name)
    assert got[3].sum() > 0


def test_collaborative_round_matches_jax(agents):
    ref_fs, ref_nm = jcollab.collaborative_round_jit(PARAMS, CCFG, agents)
    got_fs, got_nm = tcollab.collaborative_round(TP, TCCFG, to_port(agents))
    np.testing.assert_array_equal(got_nm.numpy(), np.asarray(ref_nm))
    assert_tree_close(got_fs, np_tree(ref_fs), 1e-8, "fs")
    assert int(got_nm.sum()) > 0 and int(got_nm.diagonal().sum()) == 0
