"""PyTorch port vs the JAX reference: the image front end.

Each kernel-holding module (FAST + NMS, the LK level) is held against the
JAX function through its plain version, which is what a CPU tensor runs.
Inputs come from a numpy seed; both packages get the same ones; JAX runs in
float64 as the rest of the suite. Integer and boolean outputs must match
exactly; FAST score maps must match exactly (subtract/min/max only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from torch_helpers import (CPU, F64, assert_tree_close, jax_frame_indices, jax_sample_indices,
                           np_tree, orbit_frames, stack, t, to_port)
from x_multi_agent_tpu.ops import ransac as jransac
from x_multi_agent_tpu.utils import scene as jscene
from x_multi_agent_tpu.vision import camera as jcam
from x_multi_agent_tpu.vision import fast as jfast
from x_multi_agent_tpu.vision import image as jimg
from x_multi_agent_tpu.vision import lk as jlk
from x_multi_agent_tpu.vision import tracker as jtrk
from x_multi_agent_torch import configs
from x_multi_agent_torch.ops import ransac as transac
from x_multi_agent_torch.utils import scene as tscene
from x_multi_agent_torch.vision import camera as tcam
from x_multi_agent_torch.vision import fast as tfast
from x_multi_agent_torch.vision import image as timg
from x_multi_agent_torch.vision import lk as tlk
from x_multi_agent_torch.vision import tracker as ttrk


def _textured(seed, h, w, shift=(0.7, -1.3)):
    rng = np.random.default_rng(seed)
    prev = ndi.gaussian_filter(rng.normal(size=(h, w)), 2.0) * 60 + 128
    return prev, ndi.shift(prev, shift, order=3)


@pytest.mark.parametrize("thr,nms", [(12.0, True), (9.0, True), (12.0, False)])
def test_fast_score_nms_matches_jax_exactly(thr, nms):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(2, 61, 83)).astype(np.float64)
    ref = jax.vmap(lambda im: jfast.fast_score(im, thr))(jnp.asarray(imgs))
    if nms:
        ref = jax.vmap(jfast.nms3)(ref)
    got = tfast.fast_score_nms(t(imgs), thr, nms=nms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_tile_topk_breaks_ties_like_lax_top_k():
    # integer-valued scores: ties everywhere, as FAST scores of 8-bit images
    rng = np.random.default_rng(1)
    score = rng.integers(0, 4, size=(2, 40, 48)).astype(np.float64)
    ref = jax.vmap(lambda s: jfast._tile_topk(s, 4, 4, 7, jnp.float64))(jnp.asarray(score))
    got = tfast._tile_topk(t(score), 4, 4, 7, F64)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_detect_batch_matches_jax():
    frames = orbit_frames(2, 1, 120, 160)[0][0]
    ref = jfast.detect_batch(jnp.asarray(frames), 12.0, 4, 4, 10, True)
    got = tfast.detect_batch(t(frames), 12.0, 4, 4, 10, True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_pyramid_gradients_bilinear_match_jax():
    img, _ = _textured(2, 57, 83)
    ref = jimg.build_pyramid(jnp.asarray(img), 2)
    got = timg.build_pyramid(t(img), 2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-12)
    for g, r in zip(timg.scharr_gradients(t(img)), jimg.scharr_gradients(jnp.asarray(img))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-12)
    pts = np.random.default_rng(3).uniform(-5, 90, size=(13, 2))
    np.testing.assert_allclose(
        timg.bilinear_sample(t(img), t(pts)).numpy(),
        np.asarray(jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(pts))), rtol=0, atol=1e-12,
    )


@pytest.mark.parametrize("s", [0.0, 0.9])
def test_camera_matches_jax(s):
    cam = tcam.Camera.from_fractional(0.8, 1.1, 0.5, 0.45, s, 160, 120)
    jc = jcam.Camera(*cam)
    pts = np.random.default_rng(4).uniform(0, 160, size=(3, 17, 2))
    und = tcam.undistort(cam, t(pts))
    np.testing.assert_allclose(und.numpy(), np.asarray(jcam.undistort(jc, jnp.asarray(pts))),
                               rtol=0, atol=1e-9)
    for tf_, jf_ in ((tcam.normalize, jcam.normalize), (tcam.denormalize, jcam.denormalize)):
        np.testing.assert_allclose(tf_(cam, t(pts)).numpy(),
                                   np.asarray(jf_(jc, jnp.asarray(pts))), rtol=0, atol=1e-12)


@pytest.mark.parametrize("half_win", [10, 15])
def test_track_level_matches_jax(half_win):
    h, w = 96, 160
    img0, img1 = _textured(5, h, w)
    rng = np.random.default_rng(6)
    # interior features plus features far beyond the border, whose slab
    # base the padded-image clamp pins to a corner
    pts = np.concatenate([rng.uniform([20, 20], [w - 20, h - 20], size=(24, 2)),
                          rng.uniform([-70, -70], [-45, -45], size=(8, 2)),
                          rng.uniform([w + 45, h + 45], [w + 70, h + 70], size=(8, 2))])
    guess = 0.5 * rng.normal(size=pts.shape)
    dx, dy = jimg.scharr_gradients(jnp.asarray(img0))
    f_ref, ok_ref = jlk._track_level(jnp.asarray(img0), jnp.asarray(img1), dx, dy,
                                     jnp.asarray(pts), jnp.asarray(guess), half_win, 10, 1e-4)
    tdx, tdy = timg.scharr_gradients(t(img0)[None])
    f, ok = tlk._track_level(t(img0)[None], t(img1)[None], tdx, tdy, t(pts)[None],
                             t(guess)[None], half_win, 10, 1e-4)
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(ok[0].numpy(), ok_ref)
    f, f_ref = f[0].numpy(), np.asarray(f_ref)
    inner = ok_ref & (np.arange(len(pts)) < 24)
    np.testing.assert_allclose(f[inner], f_ref[inner], rtol=0, atol=1e-9)
    # the corner-pinned windows of the far features mostly hold the padding's
    # replicated edge: G is near-singular (det cancels), so their runaway
    # flows (tens of px) carry float64 rounding amplified by 1/det
    np.testing.assert_allclose(f[24:], f_ref[24:], rtol=1e-6, atol=1e-9)
    assert inner.sum() > 10 and ok_ref[24:].any()


@pytest.mark.parametrize("half_win", [10, 15])
def test_track_level_edge_band_matches_jax(half_win):
    """Features over the image and a 25-px band around it: windows partly on
    the replicated edge, where the slab-base clamp engages while the
    Gauss-Newton steps move."""
    h, w = 96, 160
    img0, img1 = _textured(5, h, w)
    rng = np.random.default_rng(11)
    pts = rng.uniform([-25, -25], [w + 25, h + 25], size=(64, 2))
    guess = rng.normal(size=pts.shape)
    dx, dy = jimg.scharr_gradients(jnp.asarray(img0))
    f_ref, ok_ref = jlk._track_level(jnp.asarray(img0), jnp.asarray(img1), dx, dy,
                                     jnp.asarray(pts), jnp.asarray(guess), half_win, 10, 1e-4)
    args = (t(img0)[None], t(img1)[None], *timg.scharr_gradients(t(img0)[None]),
            t(pts)[None], t(guess)[None], half_win, 10, 1e-4)
    f, ok = tlk._track_level(*args)
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(ok[0].numpy(), ok_ref)
    # stable: a 1e-5 px move of the point moves the flow by <= 1e-3 px. The
    # others run away along the replicated edge, where a 1e-5 px move moves
    # the flow by up to pixels: there both float64 versions agree only to
    # their own rounding, amplified (relative 1e-6)
    stable = tlk.flow_sensitivity(*args)[1][0].numpy() <= 1e-3
    f, f_ref = f[0].numpy(), np.asarray(f_ref)
    np.testing.assert_allclose(f[stable & ok_ref], f_ref[stable & ok_ref], rtol=0, atol=1e-9)
    np.testing.assert_allclose(f, f_ref, rtol=1e-6, atol=1e-9)
    near_edge = (np.minimum(pts, [w - 1, h - 1] - pts) < half_win).any(-1)
    assert (stable & ok_ref & near_edge).sum() >= 10 and stable.mean() >= 0.5


def test_lk_track_three_levels_matches_jax():
    h, w = 96, 160
    rng = np.random.default_rng(7)
    prev, cur = [], []
    for s in (8, 9):
        p, c = _textured(s, h, w, shift=(2.6, -3.1))
        prev.append(p)
        cur.append(c)
    prev, cur = np.stack(prev), np.stack(cur)
    pts = rng.uniform([15, 15], [w - 15, h - 15], size=(2, 30, 2))
    valid = rng.random((2, 30)) > 0.2
    ref = jax.vmap(lambda p, c, x, v: jlk.track(
        jimg.build_pyramid(p, 2), jimg.build_pyramid(c, 2), x, v))(
        jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(pts), jnp.asarray(valid))
    got = tlk.track(timg.build_pyramid(t(prev), 2), timg.build_pyramid(t(cur), 2), t(pts), t(valid))
    ok = np.asarray(ref[1])
    np.testing.assert_array_equal(got[1].numpy(), ok)
    # rejected features may run away (flows of 100+ px) and amplify float64
    # rounding; the tracker drops them, so positions are held where ok
    np.testing.assert_allclose(got[0].numpy()[ok], np.asarray(ref[0])[ok], rtol=0, atol=1e-9)
    assert ok.sum() > 20


@pytest.mark.parametrize("n_valid", [60, 5])
def test_fundamental_ransac_with_jax_indices(n_valid):
    rng = np.random.default_rng(8)
    n = 64
    x = rng.uniform(0, 160, size=(n, 2))
    # a rotation + translation between views, 15 % gross outliers
    pts2 = x + np.array([3.0, -1.5]) + 0.01 * (x - 80) @ np.array([[0.0, 1.0], [-1.0, 0.0]])
    pts2[rng.random(n) < 0.15] += rng.uniform(-20, 20, size=(1, 2))
    mask = np.zeros(n, bool)
    mask[:n_valid] = True
    idx = jax_sample_indices(jnp.asarray(mask), 3, 96)
    inl_ref, f_ref = jransac.fundamental_ransac(
        jnp.asarray(x), jnp.asarray(pts2), jnp.asarray(mask),
        jax.random.fold_in(jax.random.PRNGKey(0), 3), 1.0, 96,
    )
    inl, f = transac.fundamental_ransac(t(x)[None], t(pts2)[None], t(mask)[None],
                                        t(np.asarray(idx))[None], 1.0)
    np.testing.assert_array_equal(inl[0].numpy(), np.asarray(inl_ref))
    if n_valid < 8:  # degenerate: the input mask back, F undetermined
        np.testing.assert_array_equal(inl[0].numpy(), mask)
        return
    f_ref = np.asarray(f_ref)
    np.testing.assert_allclose(f[0].numpy(), f_ref, rtol=0, atol=1e-9 * np.abs(f_ref).max())


def test_draw_sample_indices_stay_on_valid_matches():
    mask = torch.zeros((3, 50), dtype=torch.bool)
    mask[0, 10:20] = True
    mask[1, 49] = True  # agent 2 has none: uniform over all
    keys = torch.tensor([4, 5, 6], dtype=torch.int32)
    idx = transac.keyed_sample_indices(mask, 96, 8, 0, keys)
    assert idx.shape == (3, 96, 8)
    assert bool(((idx[0] >= 10) & (idx[0] < 20)).all()) and bool((idx[1] == 49).all())
    assert len(idx[0].unique()) == 10 and len(idx[2].unique()) > 40
    assert torch.equal(idx, transac.keyed_sample_indices(mask, 96, 8, 0, keys))
    assert not torch.equal(idx, transac.keyed_sample_indices(mask, 96, 8, 1, keys))


def _keyed_masks(a, n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((a, n)) < rng.uniform(0.1, 0.9, (a, 1))
    mask[0] = False  # no valid entry: over all
    return torch.from_numpy(mask)


@pytest.mark.parametrize("a", [1, 3, 7])
def test_keyed_sample_indices_rows_are_independent(a):
    """A row's draw depends on its own mask and keys only: the rows drawn
    together, each alone, and in another order agree, for any A."""
    mask = _keyed_masks(a, 40, a)
    t_key = torch.from_numpy(np.linspace(-3.0, 7.0, a))  # float64 times
    k_key = torch.arange(a, dtype=torch.int32) * 17 - 5
    idx = transac.keyed_sample_indices(mask, 16, 8, 7, 11, t_key, k_key)
    for i in range(a):
        alone = transac.keyed_sample_indices(mask[i:i + 1], 16, 8, 7, 11, t_key[i:i + 1],
                                             k_key[i:i + 1])
        assert torch.equal(alone[0], idx[i])
    perm = torch.from_numpy(np.random.default_rng(a).permutation(a))
    assert torch.equal(transac.keyed_sample_indices(mask[perm], 16, 8, 7, 11, t_key[perm],
                                                    k_key[perm]), idx[perm])


def test_keyed_sample_indices_are_uniform():
    """Over many keys the draws fall evenly on a row's valid entries: a
    chi-square test over 10 valid entries (9 degrees of freedom, 0.1 %
    critical value 27.88), and over all entries of a row with none."""
    n_rows = 4000
    mask = torch.zeros((n_rows, 50), dtype=torch.bool)
    mask[:, 3:50:5] = True
    keys = torch.arange(n_rows, dtype=torch.int64) * 7919
    idx = transac.keyed_sample_indices(mask, 4, 8, 0, keys)
    assert bool(mask.gather(1, idx.reshape(n_rows, -1)).all())
    counts = np.bincount(idx.flatten().numpy(), minlength=50)[3:50:5]
    expect = idx.numel() / 10
    assert ((counts - expect) ** 2 / expect).sum() < 27.88, counts
    none = transac.keyed_sample_indices(torch.zeros((n_rows, 8), dtype=torch.bool), 1, 8, 0, keys)
    counts = np.bincount(none.flatten().numpy(), minlength=8)
    assert ((counts - none.numel() / 8) ** 2 / (none.numel() / 8)).sum() < 24.32, counts


_M32, _GOLD = 0xFFFFFFFF, 0x9E3779B9


def _py_mix(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _py_keyed_draw(valid, n, seed, keys):
    """The keyed draw of one row in Python integers (no width limit)."""
    h = _py_mix((seed + _GOLD) & _M32)
    for k in keys:
        h = _py_mix(((h + _GOLD) & _M32) ^ (k & _M32))
    pos = [i for i, v in enumerate(valid) if v] or list(range(len(valid)))
    return [pos[((_py_mix(((h + _GOLD) & _M32) ^ _py_mix(c + 1)) >> 8) * len(pos)) >> 24]
            for c in range(n)]


def test_keyed_sample_indices_match_python_integers():
    """Keys near 2^31 and 2^32, negative integers and negative float bits
    give the draw of the same hash in Python's unbounded integers: the
    int64 arithmetic never overflows."""
    import struct

    ints = [2**31 - 1, 2**31, 2**32 - 1, -1, -(2**31), 0]
    floats = [-1.5, -3.0e38, 0.1, -0.0, 7.25, 1e-30]
    mask = _keyed_masks(len(ints), 30, 1)
    idx = transac.keyed_sample_indices(mask, 3, 8, 2**31 + 5, torch.tensor(ints, dtype=torch.int64),
                                       torch.tensor(floats, dtype=torch.float32), 2**40 + 3)
    for i, (k, f) in enumerate(zip(ints, floats)):
        bits = struct.unpack("<I", struct.pack("<f", f))[0]
        ref = _py_keyed_draw(mask[i].tolist(), 24, 2**31 + 5, [k, bits, 2**40 + 3])
        assert idx[i].flatten().tolist() == ref, i


def test_track_frame_batch_matches_jax():
    a, h, w, n = 2, 120, 160, 3
    frames = orbit_frames(a, n, h, w)[0]
    tp = configs.flagship_tracker(24)._replace(n_feat_min=20)
    jp = jtrk.TrackerParams(**tp._asdict())
    cam = configs.flagship_camera(h, w)
    jc = jcam.Camera(*cam)
    jstate = stack(jtrk.TrackerState.zero(jp, h, w, jnp.float64), a)
    tstate = to_port(jstate)
    for k in range(n):
        imgs = jnp.asarray(frames[k])
        idx = jax_frame_indices(jp, jstate, imgs)
        jstate, jm = jtrk.track_frame_batch_jit(jp, jc, jstate, imgs)
        tstate, tm_ = ttrk.track_frame_batch(tp, cam, tstate, t(frames[k]), ransac_idx=t(idx))
        # ids, levels, valid exact; points to 1e-8 px (float64 LK sums)
        assert_tree_close(tstate, np_tree(jstate), 1e-8 / (w + h), "tracker")
        assert_tree_close(tm_, np_tree(jm), 1e-8, "matches")
    assert int(np.asarray(jm.valid).sum()) > 10


def test_scene_matches_reference():
    """The port's smoke-data generator against the reference's numpy scene:
    same orbit and IMU stream, same texture (to one gray level where the
    final truncation to uint8 falls on a rounding edge), same renders."""
    kw = dict(duration=0.5, imu_rate=200.0, cam_rate=20.0, radius=1.5, omega=0.6, phase=1.0,
              yaw_amp=0.15, pitch_amp=0.10, roll_amp=0.08, z_amp=0.3, seed=2)
    ref_tr, tr = jscene.orbit_traj(**kw), tscene.orbit_traj(**kw)
    for key in ref_tr:
        np.testing.assert_array_equal(tr[key], ref_tr[key], err_msg=key)
    ref_tex = jscene.make_texture(3, size=256)
    tex = tscene.make_texture(3, size=256, device=CPU).numpy()
    diff = np.abs(tex.astype(int) - ref_tex)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-4
    ref = np.stack([
        jscene.render_wall_frame(ref_tex, tr["cam_p"][k], tr["cam_rot"][k], 60, 80, 64.0, 64.0,
                                 m_per_px=0.03)
        for k in range(3)
    ])
    got = tscene.render_wall_frames(torch.from_numpy(ref_tex), tr["cam_p"][:3],
                                    tr["cam_rot"][:3], 60, 80, 64.0, 64.0, m_per_px=0.03)
    diff = np.abs(got.numpy().astype(int) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
