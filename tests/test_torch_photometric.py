"""PyTorch port vs the JAX reference: online photometric calibration
(``photometric/calib.py``) and the ``VIO`` facade's photometric path.

Both packages get the same inputs, made from a numpy seed; JAX runs in
float64 as the rest of the suite, the port on CPU tensors in float64. The
RANSAC sample indices are the reference's own keyed draws
(``torch_helpers.jax_gain_indices`` / ``jax_photo_sampler``). Float leaves
agree to 1e-9 of their scale; integer leaves (inlier counts, ring pointer,
frame count, the LUT's uint8 output) exactly. The spatial solve's constant
direction is fixed only by its 1e-6 Tikhonov term, which scales rounding by
~1e6: its maps are compared centred at 1e-9 and their mean offset at the
bound that term sets (see ``test_spatial_solve_matches_jax``).

On a card (``gpu``-marked, skipped here): the thermal facades at 480x640,
and their last calibration against the CPU's float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import (CPU, F64, assert_tree_close, jax_gain_indices, jax_photo_indices,
                           jax_photo_sampler, np_tree, orbit_frames, port_params, stack, t)
from x_multi_agent_tpu.photometric import calib as jcal
from x_multi_agent_torch.ops.ransac import KeyedSampler
from x_multi_agent_torch.photometric import calib as tcal

REL = 1e-9


def _close(got, ref, rel=REL, path="value"):
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))) if ref.size else 0.0, 1.0)
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got, ref,
                               rtol=0, atol=rel * scale, err_msg=path)


def _pairs(rng, j, a_rel, b_rel, n_out=0, noise=1e-4):
    """History/current intensity pairs under the relative gain (a_rel,
    b_rel), with ``n_out`` gross outliers."""
    op = rng.uniform(0.1, 0.9, j)
    o = op * (a_rel - b_rel) + b_rel + rng.normal(0, noise, j)
    bad = rng.permutation(j)[:n_out]
    o[bad] += rng.uniform(0.05, 0.2, n_out) * rng.choice([-1, 1], n_out)
    return o, op


def test_gain_algebra_matches_jax():
    rng = np.random.default_rng(0)
    a1, b1, a2, b2 = 1.0 + 0.1 * rng.normal(size=(4, 16)) * np.array([[1], [0.3], [1], [0.3]])
    for name in ("relative_gains", "chain_gains"):
        ref = getattr(jcal, name)(*map(jnp.asarray, (a1, b1, a2, b2)))
        got = getattr(tcal, name)(*map(t, (a1, b1, a2, b2)))
        for g, r in zip(got, ref):
            _close(g, r, path=name)


def test_solve_gain_ls_matches_jax():
    rng = np.random.default_rng(1)
    o, op = _pairs(rng, 40, 1.06, 0.03, n_out=6)
    for w in (np.ones(40), (rng.random(40) > 0.4).astype(float), np.zeros(40)):
        ref = jcal._solve_gain_ls(jnp.asarray(o), jnp.asarray(op), jnp.asarray(w))
        got = tcal._solve_gain_ls(t(o), t(op), t(w))
        for g, r in zip(got, ref):
            _close(g, r, path="solve")


@pytest.mark.parametrize("case", ["outliers", "masked", "three_valid", "none_valid"])
def test_estimate_gains_ransac_matches_jax(case):
    """The reference's draws, its vote and refit; fewer than 4 valid pairs
    give (1, 0, 0)."""
    rng = np.random.default_rng(2)
    j = 60
    o, op = _pairs(rng, j, 1.08, 0.04, n_out=12)
    valid = {"outliers": np.ones(j, bool), "masked": rng.random(j) > 0.3,
             "three_valid": np.arange(j) < 3, "none_valid": np.zeros(j, bool)}[case]
    key = jax.random.PRNGKey(5)
    ref = jcal.estimate_gains_ransac(jnp.asarray(o), jnp.asarray(op), jnp.asarray(valid), key)
    idx = jax_gain_indices(key, valid)
    got = tcal.estimate_gains_ransac(t(o), t(op), t(valid), t(idx))
    _close(got[0], ref[0], path="a")
    _close(got[1], ref[1], path="b")
    assert int(got[2]) == int(ref[2])
    if case == "outliers":
        assert int(got[2]) >= 40
    if case in ("three_valid", "none_valid"):
        assert (float(got[0]), float(got[1]), int(got[2])) == (1.0, 0.0, 0)


def test_estimate_gains_ransac_batched_equals_rows():
    """The batch over histories gives each row's own fit."""
    rng = np.random.default_rng(3)
    rows = [_pairs(rng, 30, 1.0 + 0.02 * k, 0.01 * k, n_out=5) for k in range(3)]
    o, op = (t(np.stack([r[i] for r in rows])) for i in (0, 1))
    valid = t(rng.random((3, 30)) > 0.2)
    idx = t(rng.integers(0, 30, (3, 32, 4)))
    got = tcal.estimate_gains_ransac(o, op, valid, idx)
    for k in range(3):
        one = tcal.estimate_gains_ransac(o[k], op[k], valid[k], idx[k])
        for g, r in zip(got, one):
            assert torch.equal(g[k], r)


def _history_inputs(rng, fh, j, gains, valid_share):
    """(Fh, J) history/current intensities under per-history relative
    gains and validity masks."""
    cur = rng.uniform(0.15, 0.85, j)
    hist, valid = [], []
    for k in range(fh):
        a_rel, b_rel = gains[k]
        hist.append(cur * (a_rel - b_rel) + b_rel + rng.normal(0, 2e-4, j))
        valid.append(rng.random(j) < valid_share[k])
    return np.stack(hist), np.broadcast_to(cur, (fh, j)).copy(), np.stack(valid)


@pytest.mark.parametrize("scenario", ["warmup_gate", "sparse", "support_below_5"])
def test_process_frame_matches_jax(scenario):
    """A sequence of frames with several histories: ``off <= n_frames``
    gates the histories older than the ring holds during warm-up;
    ``sparse`` leaves some histories with <= 4 valid pairs; with
    ``support_below_5`` every history has at most 4 valid pairs, so the
    total support stays below 5 and the relative gain falls back to (1, 0)."""
    rng = np.random.default_rng(4)
    fh, j = 3, 50
    dims_j = jcal.PhotoDims(n_history=fh, n_obs=j, window=6)
    dims_t = tcal.PhotoDims(*dims_j)
    js = jcal.PhotoState.zero(dims_j, jnp.float64)
    ts = tcal.PhotoState.zero(dims_t, F64, CPU)
    share = {"warmup_gate": (0.9, 0.9, 0.9), "sparse": (0.9, 0.06, 0.5),
             "support_below_5": (0.07, 0.07, 0.07)}[scenario]
    for f in range(9):
        gains = [(1.0 + 0.01 * (k + 1), 0.003 * (k + 1)) for k in range(fh)]
        hist, cur, valid = _history_inputs(rng, fh, j, gains, share)
        if scenario == "support_below_5":
            valid &= np.cumsum(valid, axis=1) <= 4
        offsets = np.array([1, 2, 3], np.int32)
        if scenario == "warmup_gate":
            offsets = np.array([1, 4, 7], np.int32)  # the ring holds fewer frames early on
        idx = jax_photo_indices(valid, f)
        js, ja, jb = jcal.process_frame(dims_j, js, *map(jnp.asarray, (hist, cur, valid, offsets)),
                                        jax.random.PRNGKey(f), 0.02, 0.005)
        ts, ta, tb = tcal.process_frame(dims_t, ts, *map(t, (hist, cur, valid, offsets, idx)),
                                        0.02, 0.005)
        _close(ta, ja, path=f"a[{f}]")
        _close(tb, jb, path=f"b[{f}]")
        assert_tree_close(ts, np_tree(js), REL, f"state[{f}]")
    if scenario == "support_below_5":  # only the drift anchoring moves the gains
        assert abs(float(ts.params_pt[:, 0].max()) - 1.0) < 1e-12


def _spatial_inputs(rng, cx, cy, s):
    n = cx * cy
    xs, ys = np.arange(n) % cx, np.arange(n) // cx
    truth = 0.05 * ((xs - cx / 2) ** 2 + (ys - cy / 2) ** 2) / 10.0
    sid_h = rng.integers(0, n, s).astype(np.int32)
    sid_c = rng.integers(0, n, s).astype(np.int32)
    ok = (sid_h != sid_c) & (rng.random(s) > 0.1)
    vec_b = truth[sid_c] - truth[sid_h] + rng.normal(0, 1e-4, s)
    return truth, (sid_h, sid_c, vec_b, ok)


@pytest.mark.parametrize("gp", [{}, dict(gp_length_scale=1.0, gp_sigma_f=0.2, gp_sigma_n=0.005)])
def test_spatial_solve_matches_jax(gp):
    """The solve + GPR and ``expand_spatial``. The 1e-6 Tikhonov term alone
    fixes the map's constant: two correct float64 solves differ there by up
    to ~eps / 1e-6 * |A^T b|, so the centred maps are held at 1e-9 and the
    mean offsets at 1e-6 of the map's scale (measured: ~1e-9 here)."""
    rng = np.random.default_rng(6)
    cx, cy = 6, 4
    _, args = _spatial_inputs(rng, cx, cy, 400)
    ref = np.asarray(jcal.estimate_spatial_parameters(cx, cy, *map(jnp.asarray, args), **gp))
    got = tcal.estimate_spatial_parameters(cx, cy, *map(t, args), **gp).numpy()
    assert got.shape == ref.shape == (cy, cx)
    scale = np.abs(ref).max()
    assert abs(got.mean() - ref.mean()) <= 1e-6 * scale
    _close(got - got.mean(), ref - ref.mean(), path="centred map")
    for h, w, div in ((17, 23, 4), (16, 24, 4), (5, 7, 1)):
        cells = ref[: -(-h // div), : -(-w // div)]
        _close(tcal.expand_spatial(t(cells), h, w, div), jcal.expand_spatial(jnp.asarray(cells), h, w, div),
               0.0, "expand")


@pytest.mark.parametrize("cyclic", [False, True])
@pytest.mark.parametrize("spatial", [False, True])
def test_correct_image_matches_jax(cyclic, spatial):
    """Both modes, with gains that push corrected values below 0 and above
    1 (the LUT's truncation toward zero and floor modulo); the uint8 output
    exactly, the float output at 1e-9."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (24, 32)).astype(np.uint8)
    ps = rng.normal(0, 0.3, (24, 32)) if spatial else None
    for a, b in ((1.1, 0.02), (1.7, -0.4), (0.6, 0.5), (2.5, 0.1), (1.3, 0.05)):
        if a == 1.3:  # Python floats: the reference computes in float32
            (ja, jb), (ta, tb) = (a, b), (a, b)
        else:
            (ja, jb), (ta, tb) = (jnp.asarray(v, jnp.float64) for v in (a, b)), (t(a), t(b))
        ref = np.asarray(jcal.correct_image(jnp.asarray(img), ja, jb,
                                            None if ps is None else jnp.asarray(ps), cyclic))
        got = tcal.correct_image(t(img), ta, tb, None if ps is None else t(ps), cyclic)
        assert str(got.dtype).split(".")[-1] == str(ref.dtype)
        if cyclic:
            assert got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            _close(got, ref, path="corrected")
    corr = (img / 255.0) * (1.7 - -0.4) - 0.4 - (0.0 if ps is None else ps)
    assert (corr < 0).any() and (corr > 1).any()


# ---------------------------------------------------------------------------
# port-only properties (copies of tests/test_photometric.py)
# ---------------------------------------------------------------------------


def test_process_frame_tracks_gain_drift():
    """The chained estimates follow a drifting true gain (no anchoring)."""
    rng = np.random.default_rng(0)
    dims = tcal.PhotoDims(n_history=1, n_obs=80)
    st = tcal.PhotoState.zero(dims, F64, CPU)
    j = 80
    base = rng.uniform(0.2, 0.8, j)
    sampler = KeyedSampler(0, tcal.N_HYPOTHESES, tcal.SAMPLE_SIZE)
    a_truth, b_truth = 1.0, 0.0
    for _ in range(5):
        a_rel, b_rel = 1.05, 0.01
        a_truth, b_truth = tcal.chain_gains(a_truth, b_truth, a_rel, b_rel)
        o_cur = base + rng.normal(0, 1e-4, j)
        o_hist = o_cur * (a_rel - b_rel) + b_rel
        valid = torch.ones((1, j), dtype=torch.bool)
        st, a_est, b_est = tcal.process_frame(
            dims, st, t(o_hist)[None], t(o_cur)[None], valid, t(np.array([1], np.int32)),
            sampler(valid, 0, torch.arange(1)), epsilon_gap=0.0, epsilon_base=0.0,
        )
    assert abs(float(a_est) - a_truth) < 2e-2 and abs(float(b_est) - b_truth) < 2e-2


def test_spatial_solver_recovers_offsets():
    """Difference measurements recover a vignetting-like field up to a
    global constant."""
    rng = np.random.default_rng(0)
    cx, cy = 6, 4
    truth, args = _spatial_inputs(rng, cx, cy, 400)
    est = tcal.estimate_spatial_parameters(cx, cy, *map(t, args), gp_length_scale=1.0,
                                           gp_sigma_f=0.2, gp_sigma_n=0.005).numpy().reshape(-1)
    assert np.abs((est - est.mean()) - (truth - truth.mean())).max() < 0.01


def test_float32_solve_is_the_float64_solve_rounded():
    """A system whose every cell has 32 rows: in float32, A^T A + 1e-6 I
    rounds to the singular integer Laplacian, whose constant direction the
    1e-6 term alone fixed (ROADMAP C23). The solve forms and solves its
    normal equations in float64 whatever the working dtype, so a float32
    ``solve_cell_offsets`` is finite and equals the float64 solve on the
    same values rounded to float32; the reference solves in its working
    dtype, so the port departs from its float32 numerics here."""
    n = 48
    sid_hist = np.repeat(np.arange(n), 16).astype(np.int32)
    sid_cur = ((sid_hist + np.tile(np.arange(1, 17), n)) % n).astype(np.int32)
    valid = np.ones(sid_hist.size, bool)
    rhs = np.random.default_rng(0).normal(0, 0.05, sid_hist.size).astype(np.float32)
    a_mat = np.zeros((sid_hist.size, n), np.float32)
    np.add.at(a_mat, (np.arange(sid_hist.size), sid_cur), 1.0)
    np.add.at(a_mat, (np.arange(sid_hist.size), sid_hist), -1.0)
    lap32 = a_mat.T @ a_mat + np.float32(1e-6) * np.eye(n, dtype=np.float32)
    assert (np.diag(lap32) == 32).all() and not (lap32 @ np.ones(n, np.float32)).any()
    x32, seen32 = tcal.solve_cell_offsets(n, t(sid_hist), t(sid_cur), t(rhs), t(valid))
    x64, seen64 = tcal.solve_cell_offsets(n, t(sid_hist), t(sid_cur), t(rhs, F64), t(valid))
    assert x32.dtype == torch.float32 and bool(torch.isfinite(x32).all())
    assert torch.equal(x32, x64.float()) and torch.equal(seen32, seen64)


def test_correct_image_inverts_gain():
    rng = np.random.default_rng(0)
    img = rng.integers(30, 220, (32, 40)).astype(np.uint8)
    a, b = 1.1, 0.02
    distorted = np.clip((img / 255.0 - b) / (a - b) * 255.0, 0, 255).astype(np.uint8)
    rec = tcal.correct_image(t(distorted), a, b).numpy()
    assert np.median(np.abs(rec - img)) < 3.0
    rec_c = tcal.correct_image(t(distorted), a, b, cyclic_lut=True).numpy()
    mask = (img > 40) & (img < 200)
    assert np.median(np.abs(rec_c / 2.0 - img)[mask]) < 3.0


# ---------------------------------------------------------------------------
# the facade's photometric path
# ---------------------------------------------------------------------------


def thermal_frames(frames, seed=0):
    """Rendered frames (n, h, w) degraded as a thermal camera gives them
    (``scene.degrade_frames``): the per-frame gain drift a = 1 + 0.01 k,
    b = 0.002 k of the reference's thermal e2e test, the accuracy report's
    vignette 0.06 and noise 0.006; uint8 values, returned as float64."""
    from x_multi_agent_torch.utils import scene

    gains = [(1.0 + 0.01 * k, 0.002 * k) for k in range(frames.shape[0])]
    out = scene.degrade_frames(torch.from_numpy(frames), gains, 0.06, 0.006,
                               torch.Generator().manual_seed(seed))
    return out.double().numpy()


def _photo_close(tv, jv, k):
    """The port facade's photometric state against the reference's."""
    ph = tv.photo
    assert_tree_close(ph.state, np_tree(jv._photo_state), REL, f"photo_state[{k}]")
    assert ph.frame == jv._photo_frame and ph.n_hist == len(jv._photo_hist)
    for i, (j_int, j_pts, j_ids) in enumerate(jv._photo_hist):
        _close(ph.hist_int[i], j_int, path=f"hist_int[{k}][{i}]")
        _close(ph.hist_pts[i], j_pts, 1e-8, path=f"hist_pts[{k}][{i}]")
        np.testing.assert_array_equal(ph.hist_ids[i].numpy(), np.asarray(j_ids))
    assert int((ph.hist_ids[ph.n_hist:] >= 0).sum()) == 0
    sp = jv._photo_spatial
    if sp is None:
        assert ph.spatial is None and ph.ps is None
        return
    assert ph.spatial.ptr == sp["ptr"]
    for name in ("sid_hist", "sid_cur", "valid"):
        np.testing.assert_array_equal(getattr(ph.spatial, name).numpy(), np.asarray(sp[name]))
    _close(ph.spatial.rhs, sp["rhs"], path=f"rhs[{k}]")
    ref_ps = np.zeros(ph.ps.shape) if jv._photo_ps is None else np.asarray(jv._photo_ps)
    _close(ph.ps, ref_ps, 1e-8, path=f"ps[{k}]")


@pytest.mark.parametrize("spatial", [False, True])
def test_facade_photometric_matches_jax(spatial):
    """Thermal orbit frames through both facades' ``process_image_measurement``
    with calibration on (global only, and spatial with 20-px cells solved
    every 3 frames), batched IMU and the health monitor: frame by frame the
    photometric state, the corrected image the tracker saw (its
    ``prev_img``), the tracker, the filter and the slots."""
    from x_multi_agent_tpu.vio import vio as jvio
    from x_multi_agent_tpu.vision import camera as jcam
    from x_multi_agent_tpu.vision import tracker as jtrk
    from torch_helpers import jax_frame_indices
    import __graft_entry__ as ge
    from x_multi_agent_torch import configs
    from x_multi_agent_torch.vio import vio as tvio

    h, w, n = 120, 160, 7
    jp = ge._params(small=True)._replace(dtype="float64")
    tp = port_params(jp)
    trk_p = configs.flagship_tracker(jp.cfg.tracks.n_matches - 4)
    jtrk_p = jtrk.TrackerParams(**trk_p._asdict())
    cam = configs.flagship_camera(h, w)
    frames, imu = orbit_frames(1, n, h, w)
    raw = thermal_frames(frames[:, 0])
    kw = dict(n_obs=16, spatial=spatial, cell_px=20, spatial_every=3)
    jv, tv = jvio.VIO(jp), tvio.VIO(tp, device=CPU)
    jv.init_at_time(0.0)
    jv.setup_tracker(jtrk_p, jcam.Camera(*cam), h, w)
    tv.init_at_time(0.0)
    tv.setup_tracker(trk_p, cam, h, w)
    jv.enable_photometric(**kw)
    tv.enable_photometric(**kw)
    tv.photo_sampler = jax_photo_sampler()
    for v in (jv, tv):
        v.enable_health_monitor()
    for k in range(n):
        times, seqs, ws, accs = (x[k][0] for x in imu)
        for v in (jv, tv):
            v.process_imu_batch(times, seqs, ws, accs)
        pt = np.asarray(jv._photo_state.params_pt[jv._photo_state.frame_ptr])
        corrected = jcal.correct_image(jnp.asarray(raw[k]), jnp.asarray(pt[0]), jnp.asarray(pt[1]),
                                       params_ps=jv._photo_ps)
        idx = jax_frame_indices(jtrk_p, stack(jv._tracker_state, 1), jnp.asarray(corrected)[None])
        ja = jv.process_image_measurement(times[-1], k, raw[k])
        ta = tv.process_image_measurement(times[-1], k, raw[k], ransac_idx=t(idx))
        assert ja == ta, k
        _photo_close(tv, jv, k)
        assert_tree_close(tv._tracker_state, np_tree(stack(jv._tracker_state, 1)), 1e-8, "tracker")
        assert_tree_close(tv.fs, np_tree(stack(jv.fs, 1)), 1e-8, f"fs[{k}]")
        assert_tree_close(tv.slots, np_tree(stack(jv.slots, 1)), 1e-8, f"slots[{k}]")
    assert tv.n_reinits == jv.n_reinits == 0
    a, b = tv.photo.state.current()
    assert float(a - b) > 0 and abs(float(a) - 1.0) > 1e-3  # the gains moved
    if spatial:
        assert float(tv.photo.ps.abs().max()) > 0  # the map was solved


# ---------------------------------------------------------------------------
# on the card (``gpu``-marked, skipped here)
# ---------------------------------------------------------------------------

# the card's spatial map against the CPU's float64 one, largest |difference|
MAP_ERR = 1e-5


def _calibration_card_vs_cpu(frame_call, solve_call) -> dict:
    """The last ``process_frame`` and spatial solve an eager facade ran on
    the card (their arguments, and the solve's cells), again on the card
    and on the CPU in float64 from the same inputs: |da|, |db|, and the
    maps' largest difference."""
    from x_multi_agent_torch.utils.tree import map_leaves

    def cpu64(x):
        x = x.cpu()
        return x.double() if x.is_floating_point() else x

    args, kwargs = frame_call
    card = tcal.process_frame(*args, **kwargs)
    cpu = tcal.process_frame(*[map_leaves(cpu64, a) for a in args], **kwargs)
    out = {"da": abs(float(card[1]) - float(cpu[1])), "db": abs(float(card[2]) - float(cpu[2]))}
    args, kwargs, cells = solve_call
    ref = tcal.estimate_spatial_parameters(*[map_leaves(cpu64, a) for a in args], **kwargs)
    out["map_err"] = float((cells.double().cpu() - ref).abs().max())
    return out


@pytest.mark.gpu
def test_thermal_facades_on_the_card(monkeypatch):
    """Agent 0's 480x640 orbit frames degraded as :func:`thermal_frames`
    degrades them, through two facades on the card from the orbit's true
    start, the health monitor on: global gains only (compiled) and with the
    spatial map (40-px cells solved every 10 frames; eager, so that its
    last ``process_frame`` and spatial solve are kept). Each applies >= 90 %
    of its updates, never re-initializes, keeps a finite tail and finite
    gains with a - b > 0 after every frame; the global facade's corrected
    images of the last 10 frames lie closer to the clean render than the
    raw ones; the spatial map is solved and finite. The kept calibration
    against the CPU in float64 (:func:`_calibration_card_vs_cpu`): the gains
    within 1e-4, the map within MAP_ERR."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from x_multi_agent_torch import configs
    from x_multi_agent_torch.utils import scene
    from x_multi_agent_torch.utils.tree import map_leaves
    from x_multi_agent_torch.vio import vio as tvio

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, (h, w, n) = torch.device("cuda"), (480, 640, 30)
    params = configs.flagship_params()
    frames, (times, seqs, ws, accs) = scene.orbit_dataset(1, n, h, w, dev)
    clean = frames[:, 0]
    raw = torch.from_numpy(thermal_frames(clean.cpu().numpy())).to(dev, torch.uint8)
    p0, v0, q0 = scene.orbit_start(1)
    kept = {}
    frame_fn, solve_fn = tcal.process_frame, tcal.estimate_spatial_parameters

    def keep_frame(*args, **kwargs):
        kept["frame"] = map_leaves(torch.clone, (args, kwargs))
        return frame_fn(*args, **kwargs)

    def keep_solve(*args, **kwargs):
        out = solve_fn(*args, **kwargs)
        kept["solve"] = map_leaves(torch.clone, (args, kwargs, out))
        return out

    vs = {}
    for spatial in (False, True):
        v = tvio.VIO(params, device=dev, compiled=not spatial)
        v.init_at_time(0.0, p=p0[0], v=v0[0], q=q0[0])
        v.setup_tracker(configs.flagship_tracker(params.cfg.tracks.n_matches),
                        configs.flagship_camera(h, w), h, w)
        v.enable_health_monitor()
        v.enable_photometric(n_obs=80, spatial=spatial, cell_px=40, spatial_every=10, seed=5)
        vs[spatial] = v
    applied = dict.fromkeys(vs, 0)
    gains = {key: [] for key in vs}  # before each frame: the gains it is corrected with
    for k in range(n):
        for spatial, v in vs.items():
            v.process_imu_batch(*(x[k, 0].cpu().numpy() for x in (times, seqs, ws, accs)))
            gains[spatial].append(v.photo.state.current().clone())
            with monkeypatch.context() as mp:
                if spatial:
                    mp.setattr(tcal, "process_frame", keep_frame)
                    mp.setattr(tcal, "estimate_spatial_parameters", keep_solve)
                applied[spatial] += v.process_image_measurement(float(times[k, 0, -1]), k,
                                                                raw[k])
    for spatial, v in vs.items():
        g = torch.stack(gains[spatial][1:] + [v.photo.state.current()]).double()
        assert applied[spatial] >= 0.9 * n and v.n_reinits == 0, (spatial, applied)
        assert bool(torch.isfinite(v.tail_state().p).all())
        assert bool(torch.isfinite(g).all()) and bool((g[:, 0] - g[:, 1] > 0).all()), g
    g = gains[False]
    tail = range(n - 10, n)
    err_corrected = sum(float((tcal.correct_image(raw[k], g[k][0], g[k][1]).double()
                               - clean[k].double()).abs().mean()) for k in tail)
    err_raw = sum(float((raw[k].double() - clean[k].double()).abs().mean()) for k in tail)
    assert err_corrected < err_raw
    ps = vs[True].photo.ps
    assert bool((ps != 0).any()) and bool(torch.isfinite(ps).all())
    cmp = _calibration_card_vs_cpu(kept["frame"], kept["solve"])
    assert cmp["da"] <= 1e-4 and cmp["db"] <= 1e-4 and cmp["map_err"] <= MAP_ERR, cmp
