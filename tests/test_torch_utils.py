"""PyTorch port vs the JAX reference: the utilities (checkpoint, timing,
YAML config, reference-data ingestion, debug rendering, dataset IO, the
dataset generators and the renderer's second wall).

Both packages get the same inputs; JAX runs in float64 as the rest of the
suite, the port on CPU tensors. Host-side outputs (parsed arrays, ids,
pixels, CSV bytes) must be equal; float outputs of the undistortion agree to
1e-12; the generators' frames, rendered in float32 by each package's own
renderer, agree within 1 gray level.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from torch_helpers import CPU, F64, orbit_frames, port_params, t
from x_multi_agent_tpu.utils import config as jconfig
from x_multi_agent_tpu.utils import dataio as jdataio
from x_multi_agent_tpu.utils import ref_ingest as jref
from x_multi_agent_tpu.utils import render as jrender
from x_multi_agent_tpu.utils import scene as jscene
from x_multi_agent_tpu.utils.sim import make_circle_sim
from x_multi_agent_tpu.vio import pipeline as jpipe
from x_multi_agent_tpu.vision import camera as jcam
from x_multi_agent_torch import configs
from x_multi_agent_torch.utils import checkpoint, config, dataio, ref_ingest, render, scene, timing
from x_multi_agent_torch.utils.timing import Timing
from x_multi_agent_torch.vio import pipeline as tpipe
from x_multi_agent_torch.vio import vio as tvio
from x_multi_agent_torch.vision import camera as tcam

THERMAL = dict(drift_a=0.004, drift_b=0.001, noise=0.006, vignette=0.06)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _feed_matches(v, sim, frames, imu_i):
    from torch_helpers import sim_matches

    for f in frames:
        t_cam = sim.cam_t[f]
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
            v.process_imu(sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i])
            imu_i += 1
        v.process_matches_measurement(t_cam, f, sim_matches(sim, f))
    return imu_i


def test_checkpoint_resume_bit_identical(tmp_path):
    """A restored filter continues bit-identically (the reference's
    tests/test_checkpoint.py on the port's facade)."""
    from test_vio_e2e import PARAMS, TRACKS

    tp = port_params(PARAMS)
    sim = make_circle_sim(duration=2.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                          match_budget=TRACKS.n_matches, pixel_noise=5e-4, seed=1)
    v = tvio.VIO(tp, device=CPU)
    v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
    imu_i = _feed_matches(v, sim, range(10), 0)
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save(ckpt, (v.fs, v.slots))
    _feed_matches(v, sim, range(10, 20), imu_i)

    v2 = tvio.VIO(tp, device=CPU)
    v2.init_at_time(0.0)
    v2.fs, v2.slots = checkpoint.load(ckpt, (v2.fs, v2.slots))
    _feed_matches(v2, sim, range(10, 20), imu_i)
    assert torch.equal(v.tail_state().p, v2.tail_state().p)
    assert torch.equal(v.fs.cov, v2.fs.cov)
    # a template of another shape is refused
    small = tvio.VIO(port_params(PARAMS._replace(cfg=PARAMS.cfg._replace(
        dims=PARAMS.cfg.dims._replace(n_poses=6)))), device=CPU)
    small.init_at_time(0.0)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(ckpt, (small.fs, small.slots))


def test_checkpoint_photometric_facade(tmp_path):
    """A facade with spatial photometric calibration: the filter, the
    tracker and the photometric state (gain chain, history ring, frame
    counter, spatial ring and map, Python counters included) round-trip,
    and the restored facade continues bit-identically: every RANSAC draw
    is keyed on that state, so no generator state is restored."""
    h, w, n, k0 = 120, 160, 7, 4
    tp = port_params(ge._params(small=True)._replace(dtype="float64"))
    trk = configs.flagship_tracker(tp.cfg.tracks.n_matches - 4)
    cam = configs.flagship_camera(h, w)
    frames, imu = orbit_frames(1, n, h, w)
    raw = frames[:, 0] * (1.0 + 0.01 * np.arange(n))[:, None, None]

    def facade():
        v = tvio.VIO(tp, device=CPU)
        v.init_at_time(0.0)
        v.setup_tracker(trk, cam, h, w, seed=3)
        v.enable_photometric(n_obs=16, spatial=True, cell_px=20, spatial_every=3, seed=4)
        return v

    def feed(v, ks):
        for k in ks:
            times, seqs, ws, accs = (x[k][0] for x in imu)
            v.process_imu_batch(times, seqs, ws, accs)
            v.process_image_measurement(times[-1], k, raw[k])

    def state(v):
        return v.fs, v.slots, v._tracker_state, v.photo

    v = facade()
    feed(v, range(k0))
    ckpt = str(tmp_path / "facade.npz")
    checkpoint.save(ckpt, state(v))
    feed(v, range(k0, n))

    v2 = facade()
    v2.fs, v2.slots, v2._tracker_state, v2.photo = checkpoint.load(ckpt, state(v2))
    assert (v2.photo.frame, v2.photo.n_hist, v2.photo.spatial.ptr) == (k0, 3, (1 + 2 + 3) * 16)
    feed(v2, range(k0, n))
    from x_multi_agent_torch.utils.tree import leaves

    for a, b in zip(leaves(state(v)), leaves(state(v2))):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    assert float(v.photo.ps.abs().max()) > 0  # the map was solved after the restore


def _collab_pair(words, ccfg):
    """Two collaborating port facades on the circle sim (agent 1 0.25 m off
    under a loose prior), as tests/test_request_comm_loop.py sets them up."""
    from test_collab import PARAMS

    vs = []
    for uav, (off, sig) in enumerate((((0.0, 0.0, 0.0), 1e-3), ((0.25, 0.0, 0.0), 0.5))):
        v = tvio.VIO(port_params(PARAMS._replace(sigma_dp=(sig,) * 3)), device=CPU)
        v.init_at_time(0.0, p=np.asarray(off), v=np.array([1.8, 0.0, 0.0]))
        v.enable_collab(words, uav_id=uav, ccfg=ccfg, seed=uav)
        vs.append(v)
    return vs


def _pair_state(v):
    return (v.fs, v.slots, v._store, v._db, v._kf_meta, v.n_collab_consumed,
            v.n_keyframes_selected)


def test_checkpoint_collab_facade_pair(tmp_path):
    """Two facades with the collaboration's RANSAC gates on (the default
    ``pr_ransac_thr``) exchange every 3 frames; a pair restored from a
    checkpoint of the filter, tracks, match store, keyframe rings and
    keyframe counters after frame 9 gives the uninterrupted pair's hits,
    fused counts and states bit for bit over the next exchanges: every
    draw is keyed on that state, so nothing else is restored."""
    import dataclasses

    from test_collab import CCFG, TRACKS
    from torch_helpers import sim_matches
    from x_multi_agent_torch.parallel import collab as tcollab
    from x_multi_agent_torch.place_recognition.vocabulary import train_kmajority
    from x_multi_agent_torch.utils.sim import make_circle_sim as port_sim
    from x_multi_agent_torch.utils.tree import leaves

    rng = np.random.default_rng(0)
    desc_table = rng.integers(0, 256, (40, 32)).astype(np.uint8)
    words = train_kmajority(rng.integers(0, 256, (400, 32)).astype(np.uint8), 16, 5).words
    ccfg = tcollab.CollabConfig(**CCFG._replace(
        sigma_landmark=0.02, ci_slam_w=0.5, match_budget=8, desc_ratio_thr=0.9,
        desc_abs_thr=40.0, pr_score_thr=0.2)._asdict())
    assert ccfg.pr_ransac_thr > 0
    sim = port_sim(duration=2.4, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                   match_budget=TRACKS.n_matches, pixel_noise=5e-4, seed=1)

    def feed(vs, frames, imu_i):
        ex = []
        for f in frames:
            lo = imu_i
            while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= sim.cam_t[f] + 1e-9:
                imu_i += 1
            m = dataclasses.replace(
                sim_matches(sim, f), desc=t(desc_table[np.clip(sim.match_id[f], 0, 39)])[None],
                desc_valid=t(sim.match_valid[f])[None])
            for v in vs:
                for i in range(lo, imu_i):
                    v.process_imu(sim.imu_t[i], i, sim.imu_w[i], sim.imu_a[i])
                v.process_matches_measurement(sim.cam_t[f], f, m)
            if f % 3 == 2:
                for req in range(2):
                    payload, found = vs[1 - req].process_other_requests(
                        req, vs[req].get_descriptors())
                    ex.append((found, vs[req].process_other_measurements(payload, 1 - req)
                               if found else 0))
        return ex, imu_i

    k0, n = 9, len(sim.cam_t)
    vs = _collab_pair(words, ccfg)
    _, imu_i = feed(vs, range(k0), 0)
    for i, v in enumerate(vs):
        checkpoint.save(str(tmp_path / f"agent{i}.npz"), _pair_state(v))
    ref, _ = feed(vs, range(k0, n), imu_i)

    vs2 = _collab_pair(words, ccfg)
    for i, v in enumerate(vs2):
        (v.fs, v.slots, v._store, v._db, v._kf_meta, v.n_collab_consumed,
         v.n_keyframes_selected) = checkpoint.load(str(tmp_path / f"agent{i}.npz"), _pair_state(v))
    got, _ = feed(vs2, range(k0, n), imu_i)
    assert got == ref
    assert sum(fused for _, fused in ref) > 0, "no match fused after the restore"
    for v, v2 in zip(vs, vs2):
        for a, b in zip(leaves(_pair_state(v)), leaves(_pair_state(v2))):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


@pytest.mark.parametrize("seed", [0, 3])
def test_make_circle_sim_matches_jax(seed):
    """The port's copy of the circle sim gives the reference's arrays field
    by field (the dry run's per-agent phase and landmark window set)."""
    from x_multi_agent_torch.utils import sim as tsim

    kw = dict(duration=1.2, imu_rate=100.0, cam_rate=10.0, n_landmarks=30, match_budget=24,
              pixel_noise=5e-4, seed=seed, phase=0.3, lm_window=(4, 24))
    ref = make_circle_sim(**kw)
    got = tsim.make_circle_sim(**kw)
    assert got._fields == ref._fields
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def test_timing_report():
    Timing.reset()
    with Timing("off"):
        pass
    assert "off" not in Timing.report()
    timing.enable()
    try:
        for _ in range(3):
            with Timing("track"):
                sum(range(1000))
        with Timing("other"):
            pass
    finally:
        timing.disable()
    lines = Timing.report().splitlines()
    assert lines[0].split() == ["stage", "total_ms", "calls", "ms/call"]
    track = [ln for ln in lines if ln.startswith("track ")][0].split()
    assert track[2] == "3" and float(track[1]) >= 0.0
    assert any(ln.startswith("other ") for ln in lines)
    Timing.reset()
    assert len(Timing.report().splitlines()) == 1


# ---------------------------------------------------------------------------
# YAML config
# ---------------------------------------------------------------------------


def _as_plain(x):
    if hasattr(x, "_asdict"):
        return {k: _as_plain(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return [_as_plain(v) for v in x]
    return float(x) if isinstance(x, np.floating) else x


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_load_params_from_yaml_matches_jax(tmp_path, dtype):
    """Every field of the loaded parameters equals the reference loader's,
    on a file with most keys set and on one with none (the defaults)."""
    path = tmp_path / "params.yaml"
    path.write_text("\n".join([
        "n_poses_max: 10", "n_slam_features_max: 12", "state_buffer_size: 100",
        "cam1_fx: 0.46", "cam1_fy: 0.61", "cam1_cx: 0.49", "cam1_cy: 0.52",
        "cam1_s: 0.91", "cam1_img_width: 752", "cam1_img_height: 480",
        "cam1_q_ic: [0.9, 0.1, -0.2, 0.3]", "cam1_p_ic: [0.05, -0.02, 0.01]",
        "msckf_baseline: 30.0", "sigma_img: 0.012", "sigma_range: 0.1", "rho_0: 0.7",
        "sigma_rho_0: 0.4", "min_track_length: 10", "iekf_iter: 2", "g: [0, 0, -9.8]",
        "n_w: 0.01", "n_bw: 0.001", "n_a: 0.02", "n_ba: 0.0002", "sigma_dp: [0.1, 0.1, 0.1]",
        "sigma_dv: [0.2, 0.2, 0.2]", "sigma_dtheta: [1, 2, 3]", "sigma_dbw: [4, 5, 6]",
        "sigma_dba: [0.1, 0.2, 0.3]", "fast_detection_delta: 20", "non_max_supp: false",
        "block_half_length: 6", "margin: 10", "n_feat_min: 40", "outlier_method: 4",
        "outlier_param1: 0.5", "outlier_param2: 0.95", "win_size_w: 21", "win_size_h: 25",
        "max_level: 3", "min_eig_thr: 0.001", "n_tiles_h: 2", "n_tiles_w: 3",
        "max_feat_per_tile: 12", "cam1_time_offset: 0.004", "p: [1, 2, 3]", "v: [0.1, 0, 0]",
        "q: [0.7, 0.7, 0, 0]", "b_w: [0.001, 0, 0]", "b_a: [0, 0.01, 0]",
    ]) + "\n")
    empty = tmp_path / "empty.yaml"
    empty.write_text("unused_key: 1\n")
    for p in (path, empty):
        ref = jconfig.load_params_from_yaml(str(p), dtype=dtype)
        got = config.load_params_from_yaml(str(p), dtype=dtype)
        assert type(got).__name__ == type(ref).__name__ == "FullParams"
        assert _as_plain(got) == _as_plain(ref)
    assert got.vio.tdtype == getattr(torch, dtype)
    assert config.FullParams()._fields == jconfig.FullParams()._fields


# ---------------------------------------------------------------------------
# reference-data ingestion
# ---------------------------------------------------------------------------

JCAM = jcam.Camera(fx=320.0, fy=320.0, cx=320.0, cy=240.0, s=0.0, width=640, height=480)


@pytest.mark.parametrize("s", [0.0, 0.9])
def test_import_matches_matches_jax(s):
    """Block parsing, undistortion and normalization of both features, with
    and without FOV distortion; a vector whose length is not 10N raises in
    both."""
    jc = JCAM._replace(s=s)
    tc = tcam.Camera(*jc)
    rng = np.random.default_rng(2)
    blocks = np.column_stack([
        rng.integers(0, 2, 7).astype(float), np.full(7, 0.1), rng.uniform(0, 640, 7),
        rng.uniform(0, 480, 7), np.full(7, 0.2), rng.uniform(0, 640, 7), rng.uniform(0, 480, 7),
        rng.normal(size=(7, 3)),
    ])
    blocks[0, 2:4] = (320.0, 240.0)  # the principal point: r = 0
    ref = jref.import_matches(blocks.reshape(-1), jc)
    got = ref_ingest.import_matches(blocks.reshape(-1), tc)
    for name in ("cam_id", "time_prev", "time_curr", "landmarks", "track_id"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(ref, name)))
    for name in ("prev_n", "cur_n"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-12)
    for mod, c in ((jref, jc), (ref_ingest, tc)):
        with pytest.raises(ValueError):
            mod.import_matches(np.zeros(13), c)


def test_associator_matches_jax():
    """Feature-equality chaining: continued, new and dead tracks get the
    reference's ids, frame by frame."""
    rng = np.random.default_rng(3)
    ja, ta = jref.MatchAssociator(), ref_ingest.MatchAssociator()
    last = np.zeros((0, 10))
    for fr in range(6):
        keep = last[rng.random(len(last)) < 0.7]
        cont = np.column_stack([keep[:, 0], keep[:, 4:7], np.full(len(keep), 0.1 * (fr + 1)),
                                keep[:, 5:7] + rng.normal(size=(len(keep), 2)),
                                np.zeros((len(keep), 3))])
        new = np.column_stack([np.zeros(4), np.full(4, 0.1 * fr), rng.uniform(0, 600, (4, 2)),
                               np.full(4, 0.1 * (fr + 1)), rng.uniform(0, 600, (4, 2)),
                               np.zeros((4, 3))])
        vec = np.concatenate([cont, new])
        np.testing.assert_array_equal(ta.associate(vec), ja.associate(vec))
        last = vec


def test_reference_dataset_loader_matches_jax(tmp_path):
    """The layout loader on the reference test's synthesized dataset (circle
    sim, feature-equality chaining, gt.csv) and ``to_device_matches`` with
    the facade's agent axis of 1."""
    from test_ref_ingest import CAM, _synthesize

    _synthesize(str(tmp_path), duration=1.5)
    ref = jref.load_reference_dataset(str(tmp_path), CAM)
    got = ref_ingest.load_reference_dataset(str(tmp_path), tcam.Camera(*CAM))
    for name in ("imu_t", "imu_w", "imu_a", "frame_t", "gt_t", "gt_p", "gt_q"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert len(got.frames) == len(ref.frames) == 15
    for gf, rf in zip(got.frames, ref.frames):
        np.testing.assert_array_equal(gf.track_id, rf.track_id)
        np.testing.assert_allclose(gf.cur_n, rf.cur_n, rtol=0, atol=1e-12)
        np.testing.assert_allclose(gf.prev_n, rf.prev_n, rtol=0, atol=1e-12)
    for budget in (8, 40):
        jm = jref.to_device_matches(ref.frames[5], budget, dtype=jnp.float64)
        tm_ = ref_ingest.to_device_matches(got.frames[5], budget, dtype=F64, device=CPU)
        for name in ("track_id", "prev_pt", "cur_pt", "valid", "desc", "desc_valid", "tile",
                     "level"):
            g, r = getattr(tm_, name), np.asarray(getattr(jm, name))
            assert g.shape == (1,) + r.shape, name
            np.testing.assert_allclose(g[0].numpy(), r, rtol=0, atol=1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# debug rendering
# ---------------------------------------------------------------------------


def _debug_payload(rng, cfg):
    """One random FrameDebug payload: the reference's (unbatched, numpy)
    and the port's (agent axis of 1)."""
    zero = tpipe.FrameDebug.zero(cfg, 1, F64, CPU)
    vals = {}
    for name, z in zero._asdict().items():
        shape = z.shape[1:]
        if z.dtype == torch.bool:
            vals[name] = rng.random(shape) < 0.6
        elif name == "facet_ids":
            vals[name] = rng.permutation(shape[0] + 5)[:3].astype(np.int32) % cfg.dims.n_features
        else:
            vals[name] = rng.uniform(-0.6, 0.6, shape)
    ref = jpipe.FrameDebug(**vals)
    got = tpipe.FrameDebug(**{k: torch.from_numpy(np.asarray(v))[None] for k, v in vals.items()})
    return ref, got


def test_render_matches_jax():
    """Every plot draws the reference's pixels on the same payload, with
    and without a camera; the facade's ``render_debug_image`` draws the
    feature-class plot of its last debug payload (the plain image before
    one exists)."""
    rng = np.random.default_rng(4)
    cfg = configs.flagship_params(small=True).cfg
    jd, td = _debug_payload(rng, cfg)
    jc = jcam.Camera.from_fractional(0.8, 0.8 * 160 / 120, 0.5, 0.5, 0.0, 160, 120)
    tc = tcam.Camera(*jc)
    img = rng.integers(0, 256, (120, 160)).astype(np.uint8)
    for cams in ((None, None), (jc, tc)):
        np.testing.assert_array_equal(render.draw_track_classes(img, td, cams[1]),
                                      jrender.draw_track_classes(img, jd, cams[0]))
        np.testing.assert_array_equal(
            render.draw_facet(img, td, np.array([0.1, -0.05]), cams[1]),
            jrender.draw_facet(img, jd, np.array([0.1, -0.05]), cams[0]))
    pts = rng.uniform(0, 150, (2, 12, 2))
    valid, inl = rng.random(12) < 0.7, rng.random(12) < 0.7
    np.testing.assert_array_equal(render.draw_matches(img / 255.0, *pts, valid, inlier=inl),
                                  jrender.draw_matches(img / 255.0, *pts, valid, inlier=inl))
    np.testing.assert_array_equal(render.draw_cross_agent_matches(img, img[:100], *pts, valid),
                                  jrender.draw_cross_agent_matches(img, img[:100], *pts, valid))
    canvas = np.zeros((40, 60, 3), np.uint8)
    ref = canvas.copy()
    for mod, c in ((render, canvas), (jrender, ref)):
        mod.draw_text(c, (2, 28), "SLAM:12 xyz", (255, 255, 0))
        mod.draw_line(c, (-10, -10), (100, 100), (1, 2, 3))
        mod.draw_circle(c, (-5, 70), 4, (1, 2, 3))
    np.testing.assert_array_equal(canvas, ref)

    v = tvio.VIO(port_params(ge._params(small=True)._replace(dtype="float64")), debug=True,
                 device=CPU)
    np.testing.assert_array_equal(v.render_debug_image(t(img), tc), jrender.to_rgb(img))
    v.last_debug = td
    out = v.render_debug_image(t(img), tc)
    np.testing.assert_array_equal(out, jrender.draw_track_classes(img, jd, jc))
    assert (out == np.array(render.SLAM_COLOR)).all(-1).any()


# ---------------------------------------------------------------------------
# dataset IO and generators
# ---------------------------------------------------------------------------


def test_dataio_matches_jax(tmp_path, monkeypatch):
    """The readers give the arrays of the reference's numpy path on a
    dataset with header comments, ns timestamps and a short IMU row."""
    rng = np.random.default_rng(5)
    imu = np.column_stack([np.arange(50) * 5e6, rng.normal(size=(50, 6))])
    lines = ["# t,wx,wy,wz,ax,ay,az"] + [",".join(f"{v:.9f}" for v in row) for row in imu]
    (tmp_path / "imu.csv").write_text("\n".join(lines[:20] + ["1,2,3", ""] + lines[20:]))
    cam = tmp_path / "cam"
    cam.mkdir()
    entries = ["# t,filename"]
    for i in range(3):
        with open(cam / f"{i}.pgm", "wb") as f:
            f.write(b"P5\n# comment\n32 24\n255\n")
            f.write(rng.integers(0, 256, (24, 32)).astype(np.uint8).tobytes())
        entries.append(f"{i * 50000000}, {i}.pgm")
    (cam / "data.csv").write_text("\n".join(entries))
    monkeypatch.setattr(jdataio, "_NATIVE", False)
    np.testing.assert_array_equal(dataio.load_imu_csv(str(tmp_path / "imu.csv")),
                                  jdataio.load_imu_csv(str(tmp_path / "imu.csv")))
    got, ref = dataio.load_euroc_style(str(tmp_path)), jdataio.load_euroc_style(str(tmp_path))
    for name in ("imu_t", "imu_w", "imu_a", "cam_t"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert got.cam_paths == ref.cam_paths
    np.testing.assert_array_equal(dataio.load_pgm(got.cam_paths[1]), jdataio.load_pgm(ref.cam_paths[1]))
    np.testing.assert_array_equal(dataio.load_pgm_batch(got.cam_paths),
                                  jdataio.load_pgm_batch(ref.cam_paths))
    with pytest.raises(IOError):
        dataio.load_pgm(str(tmp_path / "imu.csv"))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_generate_agent_dataset_matches_jax(tmp_path):
    """The circle-trajectory generator (numpy renderer): every file byte for
    byte, and the returned arrays."""
    tex = jscene.make_texture(3, size=256, octaves=3)
    kw = dict(seed=7, duration=0.5, h=48, w=64, tex=tex, phase=0.4)
    ref = jscene.generate_agent_dataset(str(tmp_path / "jax"), **kw)
    got = scene.generate_agent_dataset(str(tmp_path / "port"), **kw)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v)
    np.testing.assert_array_equal(scene.quat_to_rot(np.array([0.1, -0.2, 0.3, 0.9])),
                                  jscene.quat_to_rot(np.array([0.1, -0.2, 0.3, 0.9])))


def test_render_side_wall_matches_jax():
    """The batched renderer with the second wall against the reference's, in
    float32 (each its own einsum / dot, so a few float32 ulps apart), on
    poses where the side wall fills part of the view."""
    tex = jscene.make_texture(0, size=512)
    tr = jscene.orbit_traj(2.0, 100.0, 10.0, yaw_amp=0.6, pitch_amp=0.1, roll_amp=0.05,
                           z_amp=0.25, seed=1)
    p, rot = tr["cam_p"][::5], tr["cam_rot"][::5]
    p = p + np.array([1.2, 0.0, 0.0])
    ref = np.asarray(jscene.render_wall_frames_jax(jnp.asarray(tex.astype(np.float32)), p, rot,
                                                   60, 80, 64.0, 64.0, wall2_x=4.0))
    got = scene.render_wall_float(t(tex), p, rot, 60, 80, 64.0, 64.0, wall2_x=4.0,
                                  dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    plain = np.asarray(jscene.render_wall_frames_jax(jnp.asarray(tex.astype(np.float32)), p, rot,
                                                     60, 80, 64.0, 64.0))
    assert (np.abs(ref - plain) > 1).mean() > 0.05  # the side wall is in view
    u8 = scene.render_wall_frames(t(tex), p, rot, 60, 80, 64.0, 64.0, wall2_x=4.0)
    f64 = scene.render_wall_float(t(tex), p, rot, 60, 80, 64.0, 64.0, wall2_x=4.0)
    assert torch.equal(u8, torch.clamp(f64, 0, 255).to(torch.uint8))


def test_orbit_dataset_renders_a_block():
    """A rank's block of the orbit data (``agents=``) is those agents' rows
    of the whole fleet's: the same orbits, frames and IMU windows."""
    full = scene.orbit_dataset(4, 2, 24, 32, CPU, tex_size=256)
    blk = scene.orbit_dataset(4, 2, 24, 32, CPU, tex_size=256, agents=slice(2, 4))
    for got, ref in zip((blk[0],) + blk[1], (full[0],) + full[1]):
        assert torch.equal(got, ref[:, 2:4])


def test_generate_agent_dataset_6dof_matches_jax(tmp_path):
    """2 s at 120x160 with the side wall and the thermal degradation: the
    CSV files byte for byte; the frames within 1 gray level (the renderers'
    float32 rounding moves a few pixels across a truncation step; the
    thermal noise is the same numpy draw); at least 99.9 % equal (measured:
    all 384000 pixels equal)."""
    tex = jscene.make_texture(0, size=512)
    kw = dict(seed=2, duration=2.0, h=120, w=160, wall2_x=4.0, tex=tex, thermal=THERMAL,
              chunk=8, phase=0.3)
    ref = jscene.generate_agent_dataset_6dof(str(tmp_path / "jax"), **kw)
    got = scene.generate_agent_dataset_6dof(str(tmp_path / "port"), device=CPU, **kw)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v)
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(jf) == sorted(tf) and len(jf) == 3 + 20
    n_eq = n_px = 0
    for name in jf:
        if not name.endswith(".pgm"):
            assert tf[name] == jf[name], name
            continue
        a = jdataio.load_pgm(str(tmp_path / "jax" / name)).astype(int)
        b = dataio.load_pgm(str(tmp_path / "port" / name)).astype(int)
        assert np.abs(a - b).max() <= 1, name
        n_eq += int((a == b).sum())
        n_px += a.size
    assert n_eq / n_px >= 0.999, n_eq / n_px
