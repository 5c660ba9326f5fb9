"""PyTorch port vs the JAX reference: the range (LRF) and sun-sensor updates.

The facet search, the facet and per-feature range rows and the solar rows on
seeded random scenes (two agents, one row set each), then one visual update
with the range and sun rows active from a state of a short reference run.
JAX runs in float64 as the rest of the suite, the port on CPU tensors in
float64; facet ids and ``found`` exactly, rows to 1e-12 of each leaf's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from test_collab import PARAMS
from torch_helpers import assert_tree_close, np_tree, port_params, sim_matches, stack, t, to_port
from x_multi_agent_tpu.ekf.state import StateDims
from x_multi_agent_tpu.utils.sim import make_circle_sim
from x_multi_agent_tpu.vio import pipeline as jpipe
from x_multi_agent_tpu.vio import track_manager as jtm
from x_multi_agent_tpu.vio import vio as jvio
from x_multi_agent_tpu.vio.range_facet import feature_triangle_at_point as j_facet
from x_multi_agent_tpu.vio.updates import range as jrange
from x_multi_agent_tpu.vio.updates import solar as jsolar
from x_multi_agent_torch.vio import pipeline as tpipe
from x_multi_agent_torch.vio import vio as tvio
from x_multi_agent_torch.vio.range_facet import feature_triangle_at_point as t_facet
from x_multi_agent_torch.vio.updates import range as trange
from x_multi_agent_torch.vio.updates import solar as tsolar

DIMS = StateDims(n_poses=5, n_features=6, buffer_size=16)
A = 2


def _scene(rng):
    """Per agent: camera window, inverse-depth features and anchors (as
    tests/test_aux_sensors.py draws them), and a small covariance."""
    m, n = DIMS.n_poses, DIMS.n_features
    q = Rotation.from_rotvec(rng.normal(size=(A * m, 3)) * 0.05).as_quat().reshape(A, m, 4)
    p = rng.normal(size=(A, m, 3)) * 0.3
    f = np.stack([rng.uniform(-0.3, 0.3, (A, n)), rng.uniform(-0.3, 0.3, (A, n)),
                  rng.uniform(0.1, 0.25, (A, n))], -1)
    anchor = rng.integers(0, m, (A, n)).astype(np.int32)
    cov = np.broadcast_to(np.eye(DIMS.d) * 1e-4, (A, DIMS.d, DIMS.d)).copy()
    return q, p, f, anchor, cov


def _rows_close(got, ref):
    for g, r, name in zip(got, ref, ("jac", "res", "noise_std")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12 * max(np.abs(np.asarray(r)).max(), 1.0), err_msg=name)


def test_facet_selection_matches_jax():
    """Random points with invalid features, a query outside every triangle
    (``found`` False, index of the first triangle), and one inside."""
    rng = np.random.default_rng(0)
    n = 7
    pts = rng.uniform(-1, 1, (3, n, 2))
    valid = rng.random((3, n)) > 0.2
    query = np.array([[0.05, -0.02], [10.0, 10.0], [0.2, 0.1]])
    ref = jax.vmap(j_facet)(*map(jnp.asarray, (pts, valid, query)))
    got = t_facet(*map(t, (pts, valid, query)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert bool(got[1][0]) and not bool(got[1][1])


@pytest.mark.parametrize("active", [True, False])
def test_range_facet_rows_match_jax(active):
    rng = np.random.default_rng(1)
    q, p, f, anchor, cov = _scene(rng)
    cur = DIMS.n_poses - 1
    ids = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    img_pt = rng.normal(size=(A, 2)) * 0.05
    meas = np.array([4.0, 6.0])
    act = np.array([active, True])

    def one(r, pt, i, ff, a, qq, pp, c, ac):
        return jrange.build(r, pt, i, ff, a, qq, pp, c, cur, 0.05, ac)

    args = (meas, img_pt, ids, f, anchor, q, p, cov, act)
    ref = jax.vmap(one)(*map(jnp.asarray, args))
    got = trange.build(*map(t, args[:8]), cur, 0.05, t(act))
    _rows_close(got, ref)


def test_range_facet_rows_in_float64_from_float32_image_points():
    """The image path's measurement carries the tracker's float32 points
    (``FrameMeasurement.from_matches``) into a float64 filter: the rows are
    those of the same points given in float64."""
    rng = np.random.default_rng(2)
    q, p, f, anchor, cov = _scene(rng)
    cur = DIMS.n_poses - 1
    ids = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    img_pt = (rng.normal(size=(A, 2)) * 0.05).astype(np.float32)
    meas = np.array([4.0, 6.0], np.float32)
    act = t(np.array([True, True]))
    state = [t(x) for x in (ids, f, anchor, q, p, cov)]
    got = trange.build(t(meas), t(img_pt), *state, cur, 0.05, act)
    ref = trange.build(t(meas).double(), t(img_pt).double(), *state, cur, 0.05, act)
    assert got.jac.dtype == torch.float64 and got.res.dtype == torch.float64
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("at_cur", [False, True])
def test_range_per_feature_rows_match_jax(at_cur):
    """General anchor, and anchor == current pose."""
    rng = np.random.default_rng(2)
    q, p, f, anchor, cov = _scene(rng)
    cur = DIMS.n_poses - 1
    feat = np.array([1, 4], np.int32)
    anchor[:, feat] = cur if at_cur else np.array([0, 2])
    meas = np.array([3.0, 5.5])
    act = np.array([True, True])

    def one(r, fi, ff, a, qq, pp, c, ac):
        return jrange.build_per_feature(r, fi, ff, a, qq, pp, c, cur, 0.05, ac)

    args = (meas, feat, f, anchor, q, p, cov, act)
    ref = jax.vmap(one)(*map(jnp.asarray, args))
    got = trange.build_per_feature(*map(t, args[:7]), cur, 0.05, t(act))
    _rows_close(got, ref)


def test_solar_rows_match_jax():
    rng = np.random.default_rng(3)
    q = Rotation.from_rotvec(rng.normal(size=(A, 3)) * 0.3).as_quat()
    angles = rng.normal(size=(A, 2)) * 20
    cov = np.broadcast_to(np.eye(DIMS.d) * 1e-4, (A, DIMS.d, DIMS.d)).copy()
    act = np.array([True, False])
    ref = jax.vmap(jsolar.build)(*map(jnp.asarray, (angles, q, cov, act)))
    got = tsolar.build(*map(t, (angles, q, cov, act)))
    _rows_close(got, ref)


def test_visual_update_with_range_and_sun_rows_matches_jax():
    """The last frame of a 1 s reference run as one match-driven update,
    with a range and a sun measurement: the same state, slots, ``applied``
    and debug payload in both packages, a facet found, and both rows
    changing the update (against the same frame without them)."""
    params = PARAMS._replace(cfg=PARAMS.cfg._replace(sigma_range=2.0))
    sim = make_circle_sim(duration=1.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                          match_budget=params.cfg.tracks.n_matches, pixel_noise=5e-4, seed=1)
    v = jvio.VIO(params)
    v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
    imu_i = 0
    for f, t_cam in enumerate(sim.cam_t):
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
            v.process_imu(sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i])
            imu_i += 1
        if f < len(sim.cam_t) - 1:
            v.process_matches_measurement(t_cam, f, _jax_matches(sim, f))
    pt = np.mean(sim.match_cur[f][sim.match_valid[f]][:8], axis=0)  # inside the SLAM points
    calib = jsolar.SolarCalib()
    s = Rotation.from_quat(np.asarray(calib.q_si)).as_matrix().T @ np.asarray(calib.sun_w)
    sun = jsolar.RAD2DEG * np.array([np.arctan2(s[0], s[2]), np.arctan2(s[1], s[2])]) + 1.0
    meas = jpipe.FrameMeasurement.from_matches(params.cfg, _jax_matches(sim, f))._replace(
        range_value=jnp.asarray(7.0), range_img_pt=jnp.asarray(pt), range_active=jnp.asarray(True),
        sun_angles=jnp.asarray(sun), sun_active=jnp.asarray(True),
    )
    ref = jvio.process_matches_debug(params, v.fs, v.slots, t_cam, meas)

    tp = port_params(params)
    p_fs, p_slots = to_port(stack(v.fs, 1)), to_port(stack(v.slots, 1))
    p_meas = tpipe.FrameMeasurement.from_matches(tp.cfg, sim_matches(sim, f))._replace(
        range_value=t([7.0]), range_img_pt=t(pt)[None], range_active=t([True]),
        sun_angles=t(sun)[None], sun_active=t([True]),
    )
    got = tvio.process_matches_debug(tp, p_fs, p_slots, t([t_cam]), p_meas)
    for name, g, r in zip(("fs", "slots", "applied", "debug"), got, ref):
        assert_tree_close(g, np_tree(stack(r, 1)), 1e-9, name)
    assert bool(got[2][0]) and bool(got[3].facet_found[0])
    for off in ({"range_active": t([False])}, {"sun_active": t([False])}):
        other = tvio.process_matches(tp, p_fs, p_slots, t([t_cam]), p_meas._replace(**off))
        assert float((other[0].cov - got[0].cov).abs().max()) > 1e-9, off


def _jax_matches(sim, f):
    return jtm.Matches.of(track_id=jnp.asarray(sim.match_id[f]),
                          prev_pt=jnp.asarray(sim.match_prev[f]),
                          cur_pt=jnp.asarray(sim.match_cur[f]),
                          valid=jnp.asarray(sim.match_valid[f]))
