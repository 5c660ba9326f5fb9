"""PyTorch port vs the JAX reference: the filter (lie, linalg,
triangulation, IMU propagation, state management, the visual update).

Both packages get the same inputs, made from a numpy seed; JAX runs in
float64 as the rest of the suite, the port on CPU tensors in float64.
Integer and boolean leaves must match exactly. The reference's SPD solves
are Newton-Schulz iterations (a TPU workaround) where the port uses
Cholesky, so float leaves agree to ~1e-12 relative, not bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from torch_helpers import F64, assert_tree_close, np_tree, stack, t, to_port
from x_multi_agent_tpu.ekf import ekf as jekf
from x_multi_agent_tpu.ekf.state import VisionState
from x_multi_agent_tpu.ops import lie as jlie
from x_multi_agent_tpu.ops import linalg as jla
from x_multi_agent_tpu.ops import triangulation as jtri
from x_multi_agent_tpu.utils.sim import make_circle_sim
from x_multi_agent_tpu.vio import pipeline as jpipe
from x_multi_agent_tpu.vio import state_manager as jsm
from x_multi_agent_tpu.vio import track_manager as jtm
from x_multi_agent_tpu.vio import vio as jvio
from x_multi_agent_torch import configs
from x_multi_agent_torch.ekf import ekf as tekf
from x_multi_agent_torch.ops import lie as tlie
from x_multi_agent_torch.ops import linalg as tla
from x_multi_agent_torch.ops import triangulation as ttri
from x_multi_agent_torch.vio import pipeline as tpipe
from x_multi_agent_torch.vio import state_manager as tsm
from x_multi_agent_torch.vio import vio as tvio

A = 2


def _close(got, ref, atol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("name", [
    "quat_multiply", "quat_to_rot", "rot_to_quat", "skew", "omega_matrix",
    "error_quat_from_small_angles", "small_angles_from_error_quat",
])
def test_lie_matches_jax(name):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(5, 3)) * np.array([[1.0], [1e-7], [0.3], [0.0], [2.0]])
    args = {
        "quat_multiply": (q, q[::-1]), "quat_to_rot": (q,),
        "rot_to_quat": (np.asarray(jlie.quat_to_rot(jnp.asarray(q))),), "skew": (v,),
        "omega_matrix": (v,), "error_quat_from_small_angles": (v,),
        "small_angles_from_error_quat": (q,),
    }[name]
    ref = getattr(jlie, name)(*map(jnp.asarray, args))
    _close(getattr(tlie, name)(*map(t, args)), ref)


def test_linalg_building_blocks_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 3, 3)) + 3 * np.eye(3)
    b = rng.normal(size=(4, 3))
    _close(tla.solve3(t(a), t(b)), jla.solve3(jnp.asarray(a), jnp.asarray(b)))
    _close(tla.inv3(t(a)), jla.inv3(jnp.asarray(a)))
    # left-nullspace projection with a masked (zero) row block
    hf = rng.normal(size=(12, 3))
    h = rng.normal(size=(12, 20))
    res = rng.normal(size=12)
    hf[8:] = h[8:] = res[8:] = 0.0
    ref = jla.nullspace_project(jnp.asarray(hf), jnp.asarray(h), jnp.asarray(res))
    got = tla.nullspace_project(t(hf), t(h), t(res))
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        _close(g, r)
    # Gram compression, Kalman update, Mahalanobis gamma at several row counts
    d = 20
    l = rng.normal(size=(d, d))
    cov = l @ l.T * 1e-2 + 1e-3 * np.eye(d)
    h = rng.normal(size=(50, d))
    res = rng.normal(size=50) * 1e-2
    std = np.full(50, 0.05)
    for g, r in zip(tla.qr_compress(t(h), t(res), t(std)),
                    jla.qr_compress(jnp.asarray(h), jnp.asarray(res), jnp.asarray(std))):
        _close(g, r, 1e-10 * np.abs(np.asarray(r)).max())
    hw, rw = h[:9] / 0.05, res[:9] / 0.05
    corr0 = rng.normal(size=d) * 1e-3
    ref = jla.kalman_update(jnp.asarray(cov), jnp.asarray(hw), jnp.asarray(rw), jnp.asarray(corr0))
    got = tla.kalman_update(t(cov), t(hw), t(rw), t(corr0))
    for g, r in zip(got, ref):
        _close(g, r, 1e-10 * np.abs(np.asarray(r)).max())
    for rows in (1, 2, 3, 7):
        ref = jla.mahalanobis_gamma(jnp.asarray(cov), jnp.asarray(hw[:rows]), jnp.asarray(rw[:rows]))
        got = tla.mahalanobis_gamma(t(cov), t(hw[:rows]), t(rw[:rows]))
        _close(got, ref, 1e-10 * abs(float(ref)))
    s = hw @ cov @ hw.T + np.eye(9)
    bb = rng.normal(size=(9, 4))
    for ref in (jla.spd_solve(jnp.asarray(s), jnp.asarray(bb)),
                jla.spd_solve_chol(jnp.asarray(s), jnp.asarray(bb))):
        _close(tla.spd_solve(t(s), t(bb)), ref, 1e-9 * np.abs(np.asarray(ref)).max())


def test_triangulate_gn_matches_jax():
    rng = np.random.default_rng(2)
    m, k = 6, 5
    q = rng.normal(size=(m, 4)) * 0.05 + np.array([0, 0, 0, 1.0])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = np.cumsum(rng.normal(size=(m, 3)) * 0.1, axis=0)
    pts_w = rng.uniform([-1, -1, 3], [1, 1, 6], size=(k, 3))
    rot = np.asarray(jlie.quat_to_rot(jnp.asarray(q)))
    cam = np.einsum("mji,kmj->kmi", rot, pts_w[:, None] - p[None])
    obs = cam[..., :2] / cam[..., 2:] + rng.normal(size=(k, m, 2)) * 1e-3
    mask = rng.random((k, m)) > 0.25
    mask[:, -1] = True
    ref = jax.vmap(lambda o, mk: jtri.triangulate_gn(o, mk, jnp.asarray(q), jnp.asarray(p), 5))(
        jnp.asarray(obs), jnp.asarray(mask))
    got = ttri.triangulate_gn(t(obs)[None], t(mask)[None], t(q)[None], t(p)[None], 5)
    _close(got[0][0], ref[0], 1e-10)
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(ref[1]))


def test_flagship_params_match_reference():
    for small in (False, True):
        ref, got = ge._params(small=small), configs.flagship_params(small=small)
        assert got.cfg.dims._asdict() == ref.cfg.dims._asdict()
        assert got.cfg.tracks._asdict() == ref.cfg.tracks._asdict()
        rc, gc = ref.cfg._asdict(), got.cfg._asdict()
        assert {k: v for k, v in gc.items() if k not in ("dims", "tracks")} == {
            k: v for k, v in rc.items() if k not in ("dims", "tracks")}
        assert {k: v for k, v in got._asdict().items() if k != "cfg"} == {
            k: v for k, v in ref._asdict().items() if k != "cfg"}
    assert got.cfg.dims.d == 69 and configs.flagship_params().cfg.dims.d == 150


def _params():
    return (ge._params(small=True)._replace(dtype="float64"),
            configs.flagship_params(small=True)._replace(dtype="float64"))


def _imu_window(sim, step, n=10):
    sl = slice(step * n + 1, (step + 1) * n + 1)
    times = np.broadcast_to(sim.imu_t[sl], (A, n)).copy()
    seqs = np.broadcast_to(np.arange(sl.start, sl.stop), (A, n)).astype(np.int32).copy()
    w = np.broadcast_to(sim.imu_w[sl], (A, n, 3)).copy()
    a = np.broadcast_to(sim.imu_a[sl], (A, n, 3)).copy()
    a[1] += 0.02 * step  # agents differ
    return times, seqs, w, a


def test_process_imu_batch_matches_jax():
    jp, tp = _params()
    sim = make_circle_sim(duration=1.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=20,
                          match_budget=24, seed=0)
    fs, _ = jvio.init_at_time(jp, 0.0, v=np.array([1.8, 0.0, 0.0]))
    fs = stack(fs, A)
    tfs = to_port(fs)
    run = jax.jit(jax.vmap(lambda f, *x: jekf.process_imu_batch_impl(jp.ekf_params, f, *x)))
    # 9 batches of 10 through a 32-slot ring with a 16-sample update lag:
    # the ring wraps and the covariance anchor advances
    for step in range(9):
        x = _imu_window(sim, step)
        fs = run(fs, *map(jnp.asarray, x))
        tfs = tekf.process_imu_batch_impl(tp.ekf_params, tfs, *map(t, x))
        assert_tree_close(tfs, np_tree(fs), 1e-9)
    assert int(np.asarray(fs.anchor_buf_idx)[0]) > 0


def _sim_matches(sim, step, rng, j):
    valid = np.broadcast_to(sim.match_valid[step], (A, j)) & (rng.random((A, j)) > 0.1)
    return jtm.Matches.of(
        jnp.asarray(np.broadcast_to(sim.match_id[step], (A, j)).astype(np.int32)),
        jnp.asarray(np.broadcast_to(sim.match_prev[step], (A, j, 2))),
        jnp.asarray(np.broadcast_to(sim.match_cur[step], (A, j, 2))),
        jnp.asarray(valid),
    )


@pytest.mark.parametrize("merge_short", [True, False])
def test_match_driven_filter_matches_jax(merge_short):
    """IMU batch + visual update (track manager, state manager, MSCKF /
    MSCKF-SLAM / SLAM rows, Kalman update, feature init) over 12 frames;
    with ``merge_short_into_stack=False`` the dead tracks' rows are applied
    in their own update before the slide (the random drops make such
    tracks on most frames)."""
    jp, tp = _params()
    jp = jp._replace(cfg=jp.cfg._replace(merge_short_into_stack=merge_short))
    tp = tp._replace(cfg=tp.cfg._replace(merge_short_into_stack=merge_short))
    j = jp.cfg.tracks.n_matches
    sim = make_circle_sim(duration=2.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=40,
                          match_budget=j, pixel_noise=1e-3, seed=0)
    fs, slots = jvio.init_at_time(jp, 0.0, v=np.array([1.8, 0.0, 0.0]))
    fs, slots = stack(fs, A), stack(slots, A)
    tfs, tslots = to_port(fs), to_port(slots)
    rng = np.random.default_rng(0)
    imu = jax.jit(jax.vmap(lambda f, *x: jekf.process_imu_batch_impl(jp.ekf_params, f, *x)))
    upd = jax.jit(jax.vmap(lambda f, s, mt, m: jvio.process_matches.__wrapped__(
        jp, f, s, mt, jpipe.FrameMeasurement.from_matches(jp.cfg, m))))
    for step in range(12):
        x = _imu_window(sim, step)
        fs = imu(fs, *map(jnp.asarray, x))
        tfs = tekf.process_imu_batch_impl(tp.ekf_params, tfs, *map(t, x))
        m = _sim_matches(sim, step, rng, j)
        mt = np.full((A,), x[0][0, -1])
        fs, slots, app = upd(fs, slots, jnp.asarray(mt), m)
        meas = tpipe.FrameMeasurement.from_matches(tp.cfg, to_port(m))
        tfs, tslots, tapp = tvio.process_matches(tp, tfs, tslots, t(mt), meas)
        np.testing.assert_array_equal(tapp.numpy(), np.asarray(app))
        assert_tree_close(tslots, np_tree(slots), 1e-9, "slots")
        assert_tree_close(tfs, np_tree(fs), 1e-9, "fs")
    assert int(np.asarray(fs.vision.n_valid_features).min()) > 0


def test_feature_init_paths_match_jax():
    jp, _ = _params()
    dims = jp.cfg.dims
    d, n, k = dims.d, dims.n_features, 4
    rng = np.random.default_rng(3)
    l = rng.normal(size=(d, d)) * 0.1
    cov = l @ l.T + 1e-3 * np.eye(d)
    vision = dataclasses.replace(VisionState.zero(dims, jnp.float64),
                                 n_valid_features=jnp.asarray(3, jnp.int32))
    h1 = rng.normal(size=(k, 3, d))
    h1[:, :, 15 + 6 * dims.n_poses:] = 0.0  # H1 has zero feature columns
    h2 = rng.normal(size=(k, 3, 3)) + 2 * np.eye(3)
    r1, feats = rng.normal(size=(k, 3)) * 1e-2, rng.normal(size=(k, 3))
    z = rng.normal(size=(k, 2)) * 0.2
    accept = np.array([True, False, True, True])
    is_ms = np.array([True, True, False, True])
    corr = rng.normal(size=d) * 1e-3
    tvis = to_port(stack(vision, 1))
    tc = t(cov)[None]
    jv, jc = jsm.init_new_features(dims, vision, jnp.asarray(cov), jnp.asarray(is_ms),
                                   *map(jnp.asarray, (h1, h2, r1, feats, z, accept, corr)),
                                   0.005, 0.5, 0.25)
    gv, gc = tsm.init_new_features(dims, tvis, tc, t(is_ms)[None],
                                   *[t(x)[None] for x in (h1, h2, r1, feats, z, accept, corr)],
                                   0.005, 0.5, 0.25)
    assert_tree_close(gv, stack(np_tree(jv), 1), 1e-10)
    _close(gc[0], jc, 1e-10 * float(np.abs(np.asarray(jc)).max()))
    jv, jc = jsm.init_msckf_slam_features(dims, vision, jnp.asarray(cov),
                                          *map(jnp.asarray, (h1, h2, r1, feats, accept, corr)),
                                          0.005)
    gv, gc = tsm.init_msckf_slam_features(dims, tvis, tc,
                                          *[t(x)[None] for x in (h1, h2, r1, feats, accept, corr)],
                                          0.005)
    assert_tree_close(gv, stack(np_tree(jv), 1), 1e-10)
    _close(gc[0], jc, 1e-10 * float(np.abs(np.asarray(jc)).max()))
    jv, jc = jsm.init_standard_slam_features(dims, vision, jnp.asarray(cov), jnp.asarray(z),
                                             jnp.asarray(accept), 0.5, 0.005, 0.25)
    gv, gc = tsm.init_standard_slam_features(dims, tvis, tc, t(z)[None], t(accept)[None],
                                             0.5, 0.005, 0.25)
    assert_tree_close(gv, stack(np_tree(jv), 1), 1e-12)
    _close(gc[0], jc, 1e-12)


def test_standalone_state_steps_match_jax():
    """``remove_features`` -> ``reparametrize_features`` -> ``slide_window``
    -> ``augment_pose`` one sandwich each, composed as the reference's
    fused-manage test composes them (tests/test_state_manager_fused.py),
    on two agents with different states, against JAX step by step and
    against the port's own fused ``manage``."""
    from x_multi_agent_tpu.ekf.state import CoreState, StateDims

    dims = StateDims(n_poses=6, n_features=5, buffer_size=16)
    rng = np.random.default_rng(8)
    lost = np.array([[True, False, False, True, False], [False, False, True, False, False]])
    q_ic, p_ic = np.array([0.0, 0.0, 0.0, 1.0]), np.array([0.1, -0.05, 0.02])
    refs, states = [], []
    for a in range(2):
        q = rng.normal(size=4)
        core = CoreState(
            time=jnp.asarray(1.0), seq=jnp.asarray(5, jnp.int32),
            p=jnp.asarray(rng.normal(size=3)), v=jnp.asarray(rng.normal(size=3)),
            q=jnp.asarray(q / np.linalg.norm(q)), b_w=jnp.asarray(rng.normal(size=3) * 0.01),
            b_a=jnp.asarray(rng.normal(size=3) * 0.01), w_m=jnp.zeros(3), a_m=jnp.zeros(3),
        )
        qs = rng.normal(size=(dims.n_poses, 4))
        anchors = rng.integers(0, dims.n_poses, size=dims.n_features)
        anchors[a] = 0  # force a reparametrization
        vision = VisionState(
            p_arr=jnp.asarray(rng.normal(size=(dims.n_poses, 3))),
            q_arr=jnp.asarray(qs / np.linalg.norm(qs, axis=1, keepdims=True)),
            f_arr=jnp.asarray(rng.normal(size=(dims.n_features, 3)) + 2.0),
            anchor_idx=jnp.asarray(anchors, jnp.int32),
            n_valid_poses=jnp.asarray(6 - a, jnp.int32),
            n_valid_features=jnp.asarray(4 + a, jnp.int32),
        )
        m = rng.normal(size=(dims.d, dims.d))
        cov = jnp.asarray(m @ m.T / dims.d + np.eye(dims.d) * 1e-3)
        states.append((core, vision, cov))
        v, c, perm, nk = jsm.remove_features(dims, vision, cov, jnp.asarray(lost[a]))
        steps = [(v, c, perm, nk)]
        v, c = jsm.reparametrize_features(dims, v, c)
        steps.append((v, c))
        v, c = jsm.slide_window(dims, v, c)
        steps.append((v, c))
        steps.append(jsm.augment_pose(dims, core, v, c, jnp.asarray(q_ic), jnp.asarray(p_ic)))
        refs.append(steps)

    def batch(k):
        return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                            *[s[k] for s in states])

    tdims = tsm.StateDims(*dims)
    tcore, tvis, tcov = to_port(batch(0)), to_port(batch(1)), t(batch(2))
    tq, tp_ = t(q_ic), t(p_ic)
    got = [tsm.remove_features(tdims, tvis, tcov, t(lost))]
    got.append(tsm.reparametrize_features(tdims, *got[-1][:2]))
    got.append(tsm.slide_window(tdims, *got[-1][:2]))
    got.append(tsm.augment_pose(tdims, tcore, got[-1][0], got[-1][1], tq, tp_))
    for k, step in enumerate(got):
        ref = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                           *[r[k] for r in refs])
        assert_tree_close(step[0], ref[0], 1e-12, f"vision[{k}]")
        _close(step[1], ref[1], 1e-10)
        for g, r in zip(step[2:], ref[2:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    v_f, cov_f, perm_f, nk_f = tsm.manage(tdims, tcore, tvis, tcov, t(lost), tq, tp_)
    assert_tree_close(v_f, ref[0], 1e-12, "fused vision")  # ref: the last step's
    _close(cov_f, ref[1], 1e-10)
    np.testing.assert_array_equal(perm_f.numpy(), got[0][2].numpy())
    np.testing.assert_array_equal(nk_f.numpy(), got[0][3].numpy())
