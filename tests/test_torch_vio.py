"""PyTorch port vs the JAX reference: the single-agent ``VIO`` facade.

The port's facade holds one agent with an agent axis of 1; the reference's
holds it unbatched. Both are driven with the same inputs: a match-driven
``make_circle_sim`` run (per-sample and batched IMU, range and sun
measurements, the debug payload), three rendered frames through the image
path (RANSAC gets the reference's own draws), the health monitor's re-init
(plain and escalated), the aux-less ``process_update`` and the
collaborative-gain experiment at a shortened duration. JAX runs in float64
as the rest of the suite, the port on CPU tensors in float64; integer and
boolean leaves (applied, n_reinits, slot ids, match counts) exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import __graft_entry__ as ge
from test_collab import CCFG, PARAMS
from torch_helpers import (CPU, F64, assert_tree_close, jax_frame_indices, np_tree, orbit_frames,
                           port_params, sim_matches, stack, t)
from x_multi_agent_tpu.ekf import buffer as jrb
from x_multi_agent_tpu.ekf import ekf as jekf
from x_multi_agent_tpu.ekf import state as jstate
from x_multi_agent_tpu.utils import evaluation as j_eval
from x_multi_agent_tpu.utils.collab_eval import run_collab_gain as j_run_collab_gain
from x_multi_agent_tpu.utils.sim import make_circle_sim
from x_multi_agent_tpu.vio import track_manager as jtm
from x_multi_agent_tpu.vio import vio as jvio
from x_multi_agent_tpu.vio.updates import solar as jsolar
from x_multi_agent_tpu.vision import camera as jcam
from x_multi_agent_tpu.vision import tracker as jtrk
from x_multi_agent_torch import configs
from x_multi_agent_torch.ekf import ekf as tekf
from x_multi_agent_torch.ekf import state as tstate
from x_multi_agent_torch.parallel import collab as tcollab
from x_multi_agent_torch.utils import evaluation as t_eval
from x_multi_agent_torch.utils.collab_eval import run_collab_gain as t_run_collab_gain
from x_multi_agent_torch.vio import track_manager as ttm
from x_multi_agent_torch.vio import vio as tvio

TP = port_params(PARAMS)


def _state_close(got, ref, rel, path):
    """Port CoreState (A = 1) vs the reference's unbatched one; leaves
    near zero (the biases) are held to ``rel`` in absolute units."""
    assert_tree_close(got, np_tree(stack(ref, 1)), rel, path, floor=1.0)


def _sun_angles():
    """Sun angles the sensor reads at identity attitude (the sim's)."""
    calib = jsolar.SolarCalib()
    r_si = Rotation.from_quat(np.asarray(calib.q_si)).as_matrix()
    s = r_si.T @ (np.asarray(calib.sun_w) / np.linalg.norm(calib.sun_w))
    return jsolar.RAD2DEG * np.arctan2(s[0], s[2]), jsolar.RAD2DEG * np.arctan2(s[1], s[2])


@pytest.fixture(scope="module")
def match_run():
    """One match-driven run through both facades (debug on), recording
    per-frame tail and anchor states and ``applied``."""
    sim = make_circle_sim(duration=1.2, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                          match_budget=PARAMS.cfg.tracks.n_matches, pixel_noise=5e-4, seed=2)
    jv, tv = jvio.VIO(PARAMS, debug=True), tvio.VIO(TP, debug=True, device=CPU)
    for v in (jv, tv):
        v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
    rec = []
    imu_i = 0
    for f, t_cam in enumerate(sim.cam_t):
        lo = imu_i
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
            imu_i += 1
        sl = slice(lo, imu_i)
        if f % 2 == 0:  # per-sample path
            for i in range(lo, imu_i):
                for v in (jv, tv):
                    v.process_imu(sim.imu_t[i], i, sim.imu_w[i], sim.imu_a[i])
        else:
            args = (sim.imu_t[sl], np.arange(lo, imu_i), sim.imu_w[sl], sim.imu_a[sl])
            jv.process_imu_batch(*args)
            tv.process_imu_batch(*args)
        if f % 3 == 2:
            for v in (jv, tv):
                v.set_last_range_measurement(7.0, np.array([0.01, -0.02]))
                v.set_last_sun_angle_measurement(*_sun_angles())
        jm = jtm.Matches.of(
            track_id=jnp.asarray(sim.match_id[f]), prev_pt=jnp.asarray(sim.match_prev[f]),
            cur_pt=jnp.asarray(sim.match_cur[f]), valid=jnp.asarray(sim.match_valid[f]),
        )
        ja = jv.process_matches_measurement(t_cam, f, jm)
        ta = tv.process_matches_measurement(t_cam, f, sim_matches(sim, f))
        rec.append((ja, ta, np_tree(jv.tail_state()), tv.tail_state(),
                    np_tree(jv.anchor_state()), tv.anchor_state()))
    return jv, tv, rec


def test_facade_match_run_matches_jax(match_run):
    jv, tv, rec = match_run
    for f, (ja, ta, j_tail, t_tail, j_anchor, t_anchor) in enumerate(rec):
        assert ja == ta, f
        _state_close(t_tail, j_tail, 1e-9, f"tail[{f}]")
        _state_close(t_anchor, j_anchor, 1e-9, f"anchor[{f}]")
    assert all(r[0] for r in rec[1:])
    assert_tree_close(tv.fs, np_tree(stack(jv.fs, 1)), 1e-8, "fs")
    assert_tree_close(tv.slots, np_tree(stack(jv.slots, 1)), 1e-8, "slots")


def test_facade_debug_payload_matches_jax(match_run):
    jv, tv, _ = match_run
    assert_tree_close(tv.last_debug, np_tree(stack(jv.last_debug, 1)), 1e-9, "debug")
    for got, ref in zip(tv.get_msckf_tracks() + (tv.get_slam_features_cartesian(),),
                        jv.get_msckf_tracks() + (jv.get_slam_features_cartesian(),)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * max(1.0, np.abs(ref).max(initial=0)))
    assert len(tv.get_slam_features_cartesian()) > 0


def test_image_measurement_matches_jax():
    """Three frames through ``process_image_measurement`` with batched IMU
    and the health monitor on; the tracker's budget is below the
    pipeline's, so the facade pads the matches."""
    h, w, n = 120, 160, 3
    jp = ge._params(small=True)._replace(dtype="float64")
    tp = port_params(jp)
    trk_p = configs.flagship_tracker(jp.cfg.tracks.n_matches - 4)
    jtrk_p = jtrk.TrackerParams(**trk_p._asdict())
    cam = configs.flagship_camera(h, w)
    frames, imu = orbit_frames(1, n, h, w)
    jv, tv = jvio.VIO(jp), tvio.VIO(tp, device=CPU)
    jv.init_at_time(0.0)
    jv.setup_tracker(jtrk_p, jcam.Camera(*cam), h, w)
    tv.init_at_time(0.0)
    tv.setup_tracker(trk_p, cam, h, w)
    for v in (jv, tv):
        v.enable_health_monitor()
    for k in range(n):
        times, seqs, ws, accs = (x[k][0] for x in imu)
        for v in (jv, tv):
            v.process_imu_batch(times, seqs, ws, accs)
        idx = jax_frame_indices(jtrk_p, stack(jv._tracker_state, 1), jnp.asarray(frames[k]))
        ja = jv.process_image_measurement(times[-1], k, frames[k][0])
        ta = tv.process_image_measurement(times[-1], k, frames[k][0], ransac_idx=t(idx))
        assert ja == ta, k
        assert_tree_close(tv._tracker_state, np_tree(stack(jv._tracker_state, 1)), 1e-8, "tracker")
        assert_tree_close(tv.fs, np_tree(stack(jv.fs, 1)), 1e-8, f"fs[{k}]")
        assert_tree_close(tv.slots, np_tree(stack(jv.slots, 1)), 1e-8, f"slots[{k}]")
        assert_tree_close(tv._last_matches, np_tree(stack(jv._last_matches, 1)), 1e-8, "matches")
    assert ta and tv.n_reinits == jv.n_reinits == 0
    assert int(tv._last_matches.valid.sum()) > 10


def test_reinit_from_current_matches_jax():
    """The health monitor's re-init twice: the second, within the streak,
    escalates (velocity and biases reset under a wide prior)."""
    jv, tv = jvio.VIO(PARAMS), tvio.VIO(TP, device=CPU)
    for v in (jv, tv):
        v.init_at_time(0.0, v=np.array([0.5, 0.0, 0.0]))
        v.enable_health_monitor(min_matches=8, max_bad_frames=1)
    rng = np.random.default_rng(4)
    seq = 0
    for step in range(2):
        for _ in range(10):
            w_m, a_m = rng.normal(size=3) * 0.05, np.array([0.2, 0.0, 9.81]) + rng.normal(size=3) * 0.1
            for v in (jv, tv):
                v.process_imu(0.01 * (seq + 1), seq, w_m, a_m)
            seq += 1
        for v in (jv, tv):
            v._reinit_from_current()
        assert tv.n_reinits == jv.n_reinits == step + 1
        assert_tree_close(tv.fs, np_tree(stack(jv.fs, 1)), 1e-10, f"fs[{step}]")
    assert float(torch.abs(tv.tail_state().v).max()) == 0.0  # escalated


def test_init_at_time_core_cov_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(15, 15))
    core_cov = x @ x.T * 1e-3
    p, v = np.array([0.1, -0.2, 0.3]), np.array([1.0, 0.0, 0.5])
    ref = jvio.init_at_time(PARAMS, 0.25, p=p, v=v, core_cov=core_cov)
    got = tvio.init_at_time(TP, 0.25, 1, CPU, p=p, v=v, core_cov=core_cov)
    assert_tree_close(got, np_tree(stack(ref, 1)), 0.0, "init")
    assert float(got[0].cov[0, 20, 20]) == 0.0


def _shift_update(jax_side: bool):
    """An update that applies a fixed correction and shrinks the covariance."""
    d = PARAMS.cfg.dims.d
    corr = 1e-3 * np.sin(np.arange(d))

    if jax_side:
        def fn(core, vision, cov):
            c = jnp.asarray(corr)
            return (jstate.correct_core(core, c), jstate.correct_vision(vision, c, PARAMS.cfg.dims),
                    0.9 * cov)
        return fn

    def fn(core, vision, cov):
        c = t(corr)[None].expand(cov.shape[0], d)
        return tstate.correct_core(core, c), tstate.correct_vision(vision, c, TP.cfg.dims), 0.9 * cov
    return fn


_JAX_SHIFT = _shift_update(True)


def test_process_update_matches_jax(match_run):
    """The aux-less update path at a buffer time inside the window, and at
    one outside it (dropped)."""
    jv, tv, _ = match_run
    jt = np.asarray(jrb.times(jv.fs.buffer))
    for meas_time, applied in ((float(jt[int(jv.fs.head)]), True), (1e3, False)):
        ref_fs, ref_ok = jekf.process_update(PARAMS.ekf_params, jv.fs, meas_time, _JAX_SHIFT)
        got_fs, got_ok = tekf.process_update(TP.ekf_params, tv.fs, t([meas_time]),
                                             _shift_update(False))
        assert bool(got_ok[0]) == bool(ref_ok) == applied
        assert_tree_close(got_fs, np_tree(stack(ref_fs, 1)), 1e-10, "fs")


def test_run_collab_gain_matches_jax():
    """The collaborative-gain experiment at 1.5 s (3 exchange rounds)."""
    duration = 1.5
    ref = j_run_collab_gain(PARAMS, CCFG, duration=duration)
    sim = make_circle_sim(duration=duration, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                          match_budget=PARAMS.cfg.tracks.n_matches, pixel_noise=5e-4, seed=1)
    ccfg = tcollab.CollabConfig(**{f: getattr(CCFG, f) for f in tcollab.CollabConfig._fields})
    got = t_run_collab_gain(TP, ccfg, sim, device=CPU)
    assert (got.n_rounds, got.n_matches) == (ref.n_rounds, ref.n_matches)
    for name in ("ate_solo", "ate_collab", "ate_helper"):
        assert abs(getattr(got, name) - getattr(ref, name)) < 1e-6, name
    assert abs(got.mean_nees_collab - ref.mean_nees_collab) < 1e-6 * ref.mean_nees_collab
    assert got.n_matches > 0 and got.gain > 0.2


def test_matches_constructors_match_jax():
    dims = PARAMS.cfg.tracks
    assert_tree_close(ttm.Matches.zero(dims, 1, F64, CPU), np_tree(stack(jtm.Matches.zero(dims), 1)), 0.0,
                      "zero")
    rng = np.random.default_rng(6)
    ids = rng.integers(-1, 30, size=(5,)).astype(np.int32)
    pts = rng.normal(size=(2, 5, 2))
    ref = jtm.Matches.of(jnp.asarray(ids), jnp.asarray(pts[0]), jnp.asarray(pts[1]),
                         jnp.asarray(ids >= 0))
    got = ttm.Matches.of(t(ids)[None], t(pts[0])[None], t(pts[1])[None], t(ids >= 0)[None])
    assert_tree_close(got, np_tree(stack(ref, 1)), 0.0, "of")


def test_evaluation_matches_jax():
    """ATE (with and without SE(3) alignment), the Sim(3) alignment and
    the position NEES on a rotated, shifted, noisy copy of a trajectory."""
    rng = np.random.default_rng(7)
    gt = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    rot = Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix()
    est = 1.1 * gt @ rot.T + np.array([0.5, -1.0, 2.0]) + rng.normal(size=gt.shape) * 0.01
    x = rng.normal(size=(40, 3, 3))
    cov = x @ x.transpose(0, 2, 1) + np.eye(3)
    for align in (False, True):
        assert abs(t_eval.ate_rmse(est, gt, align) - j_eval.ate_rmse(est, gt, align)) < 1e-12
    for got, ref in zip(t_eval.align_umeyama(est, gt, True), j_eval.align_umeyama(est, gt, True)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_eval.nees(est, gt, cov), j_eval.nees(est, gt, cov), rtol=1e-12)
