"""The hand-written CUDA kernels (K1 FAST, K2 LK level, the filter's track
rows) against their plain PyTorch versions, and the card's float32 collaborative rounds (the full-map
round and the descriptor-driven request-response round) against the CPU's
float64 ones, with no synchronizing operation inside a round.

Tests marked ``gpu`` need a CUDA card and skip without one; they run on the
card with ``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``
(``--noconftest``: nothing here needs the suite's JAX set-up). The CPU tests check the dispatch
rule: a CPU tensor goes to the plain version and leaves the launch counter
as it was, and the compass-tap rejection rule K1 relies on.
"""
import hypothesis.extra.numpy as hnp
import hypothesis.strategies as hst
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
import track_rows_inputs as rows_in
from hypothesis import given, settings

from x_multi_agent_torch import configs
from x_multi_agent_torch.ekf.state import StateDims
from x_multi_agent_torch.ops.ransac import KeyedSampler
from x_multi_agent_torch.parallel import collab
from x_multi_agent_torch.place_recognition import database as db_mod
from x_multi_agent_torch.place_recognition.vocabulary import train_kmajority
from x_multi_agent_torch.utils import tree
from x_multi_agent_torch.vio import pipeline
from x_multi_agent_torch.vio import track_manager as tm
from x_multi_agent_torch.vio import vio
from x_multi_agent_torch.vio.updates import msckf, msckf_slam, slam, track_rows
from x_multi_agent_torch.vision import fast, lk
from x_multi_agent_torch.vision.image import scharr_gradients


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _textured(rng, a, h, w, shift=(0.7, -1.3)):
    prev = np.stack([ndi.gaussian_filter(rng.normal(size=(h, w)), 2.0) * 60 + 128
                     for _ in range(a)])
    cur = np.stack([ndi.shift(p, shift, order=3) for p in prev])
    return prev.astype(np.float32), cur.astype(np.float32)


def test_fast_cpu_tensor_uses_plain_version():
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 255, size=(2, 40, 56)).astype(np.float32))
    before = fast.K1.launches
    got = fast.fast_score_nms(imgs, 12.0, nms=True)
    assert fast.K1.launches == before
    torch.testing.assert_close(got, fast.nms3(fast.fast_score(imgs, 12.0)), rtol=0, atol=0)


def test_lk_cpu_tensor_uses_plain_version():
    rng = np.random.default_rng(1)
    prev, cur = _textured(rng, 2, 48, 64)
    prev, cur = torch.from_numpy(prev), torch.from_numpy(cur)
    dx, dy = scharr_gradients(prev)
    pts = torch.from_numpy(rng.uniform(12, 36, size=(2, 9, 2)).astype(np.float32))
    guess = torch.zeros_like(pts)
    before = lk.K2.launches
    flow, ok = lk.track_level(prev, cur, dx, dy, pts, guess, 10, 10, 1e-4)
    assert lk.K2.launches == before
    f_ref, ok_ref = lk._track_level(prev, cur, dx, dy, pts, guess, 10, 10, 1e-4)
    torch.testing.assert_close(flow, f_ref, rtol=0, atol=0)
    assert torch.equal(ok, ok_ref)


@pytest.mark.gpu
# odd sizes, then the image fleets' two detection levels at 16 agents
@pytest.mark.parametrize("shape", [(3, 77, 133), (2, 120, 160), (16, 480, 640), (16, 240, 320),
                                   (64, 480, 640)])
@pytest.mark.parametrize("nms", [True, False])
def test_fast_kernel_matches_plain_exactly(cuda, shape, nms):
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.integers(0, 255, size=shape).astype(np.float32)).to(cuda)
    before = fast.K1.launches
    got = fast.fast_score_nms(imgs, 12.0, nms=nms)
    torch.cuda.synchronize()
    assert fast.K1.launches == before + 1
    score = fast.fast_score(imgs, 12.0)
    ref = fast.nms3(score) if nms else score
    # only subtract/min/max/compare: bit-exact
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _rejection_images():
    """Rendered orbit frames (2 agents, 120x160, both pyramid levels) and
    seeded random images (uniform bytes, Gaussian noise, smooth texture)."""
    from x_multi_agent_torch.utils.scene import orbit_dataset
    from x_multi_agent_torch.vision.image import build_pyramid

    frames, _ = orbit_dataset(2, 1, 120, 160, "cpu", tex_size=512)
    rng = np.random.default_rng(9)
    return build_pyramid(frames[0], 1) + [
        torch.from_numpy(rng.integers(0, 256, size=(2, 64, 80)).astype(np.float32)),
        torch.from_numpy(rng.normal(128, 40, size=(2, 64, 80)).astype(np.float32)),
        torch.from_numpy(_textured(rng, 2, 64, 80)[0]),
    ]


@pytest.mark.parametrize("thr", [0.0, 5.0, 12.0, 40.0])
def test_fast_rejection_rule_keeps_every_corner(thr):
    """K1 scores only pixels where two cyclically adjacent compass taps pass
    in one polarity (``fast.compass_candidates``); every pixel whose plain
    score exceeds the threshold must be one, in the polarity that scores."""
    n_cand = n_corner = n_px = 0
    for img in _rejection_images():
        score = fast.fast_score(img, thr)
        cand = fast.compass_candidates(img, thr)
        assert bool(cand[score > 0].all())
        n_cand, n_corner = n_cand + int(cand.sum()), n_corner + int((score > 0).sum())
        n_px += img.numel()
        h, w = img.shape[-2:]
        interior = torch.zeros((h, w), dtype=torch.bool)
        interior[3:h - 3, 3:w - 3] = True
        d = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1)) - img
                         for dy, dx in fast.CIRCLE])
        for v in (d, -d):  # bright, then dark: its arc passes only with its own pair
            arc = torch.stack([torch.stack([v[(k + j) % 16] for j in range(9)]).amin(0)
                               for k in range(16)]).amax(0)
            pair = torch.stack([(v[4 * k] > thr) & (v[(4 * k + 4) % 16] > thr)
                                for k in range(4)]).any(0)
            assert bool(pair[(arc > thr) & interior].all())
    assert n_corner > 0 and n_cand < n_px


@given(d=hnp.arrays(np.float32, 16, elements=hst.floats(-255, 255, width=32)),
       thr=hst.floats(0, 60, width=32))
@settings(max_examples=300, deadline=None)
def test_fast_rejection_rule_on_circles(d, thr):
    """Any 16 circle differences: a 9-arc whose minimum exceeds thr (either
    polarity) implies two cyclically adjacent compass taps exceeding it."""
    for v in (d, -d):
        arc = max(min(v[(k + j) % 16] for j in range(9)) for k in range(16))
        pair = any(v[4 * k] > thr and v[(4 * k + 4) % 16] > thr for k in range(4))
        assert pair or not arc > thr


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 77, 133), (1, 240, 320)])
@pytest.mark.parametrize("thr", [0.0, 12.0])
@pytest.mark.parametrize("kind", ["flat", "noise"])
def test_fast_kernel_exact_on_flat_and_noise(cuda, shape, thr, kind):
    """K1 exact where every pixel is rejected (flat) and where most take the
    full score (Gaussian noise), with and without NMS."""
    rng = np.random.default_rng(7)
    if kind == "flat":
        imgs = np.full(shape, 97.0, np.float32)
    else:
        imgs = rng.normal(128, 60, size=shape).astype(np.float32)
    imgs = torch.from_numpy(imgs).to(cuda)
    share = float(fast.compass_candidates(imgs, thr).float().mean())
    assert share == 0.0 if kind == "flat" else share > 0.5
    for nms in (True, False):
        got = fast.fast_score_nms(imgs, thr, nms=nms)
        score = fast.fast_score(imgs, thr)
        torch.testing.assert_close(got, fast.nms3(score) if nms else score, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("half_win", [3, 10, 15])
def test_lk_kernel_mixed_convergence(cuda, half_win):
    """K2 at 3 x 701 features (not a multiple of any warps-per-block count),
    guesses that converge after 1 to 10 steps mixed within each block."""
    rng = np.random.default_rng(8)
    prev, cur = _textured(rng, 3, 120, 200)
    prev, cur = torch.from_numpy(prev).to(cuda), torch.from_numpy(cur).to(cuda)
    dx, dy = scharr_gradients(prev)
    pts = rng.uniform([20, 20], [180, 100], size=(3, 701, 2))
    shift = np.array([-1.3, 0.7])  # (dx, dy) of _textured's (0.7, -1.3) shift
    guess = shift + rng.choice([0.0, 0.5, 2.0], size=(3, 701, 1)) * rng.normal(size=(3, 701, 2))
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    guess = torch.from_numpy(guess.astype(np.float32)).to(cuda)
    args = (prev, cur, dx, dy, pts, guess, half_win, 10, 1e-4)
    flow, ok = lk.track_level(*args)
    torch.cuda.synchronize()
    f_ref, ok_ref, iters = lk._track_level(*args, return_iters=True)
    assert len(torch.unique(iters)) >= 3
    st = lk.level_agreement(f_ref, ok_ref, flow, ok, lk.gate_margin(dx, dy, pts, half_win, 1e-4))
    assert st["ok_agree"] >= 0.995 and st["max_disagree_margin"] <= 1e-3, st
    assert st["max_flow_err"] <= 2e-2 and st["share_within_1e-3"] >= 0.99, st
    assert st["n_both_ok"] > 1000, st


@pytest.mark.gpu
@pytest.mark.parametrize("half_win", [10, 15])
def test_lk_kernel_matches_plain(cuda, half_win):
    rng = np.random.default_rng(3)
    prev, cur = _textured(rng, 2, 96, 160)
    prev, cur = torch.from_numpy(prev).to(cuda), torch.from_numpy(cur).to(cuda)
    dx, dy = scharr_gradients(prev)
    # interior features with small guesses (they converge), plus features
    # far outside the image: the slab-base clamp path (their window stays at
    # the clamped corner of the padded image)
    inner = rng.uniform([14, 14], [146, 82], size=(2, 56, 2))
    outer = rng.uniform([-60, -60], [-40, -40], size=(2, 8, 2))
    pts = torch.from_numpy(np.concatenate([inner, outer], 1).astype(np.float32)).to(cuda)
    guess = torch.from_numpy((0.3 * rng.normal(size=(2, 64, 2))).astype(np.float32)).to(cuda)
    before = lk.K2.launches
    flow, ok = lk.track_level(prev, cur, dx, dy, pts, guess, half_win, 10, 1e-4)
    torch.cuda.synchronize()
    assert lk.K2.launches == before + 1
    f_ref, ok_ref = lk._track_level(prev, cur, dx, dy, pts, guess, half_win, 10, 1e-4)
    margin = lk.gate_margin(dx, dy, pts, half_win, 1e-4)
    st = lk.level_agreement(f_ref, ok_ref, flow, ok, margin)
    # float32 sums in another order: ok may flip only at the gate; the early
    # exit may add one step of |dnu| <= eps = 0.01 px
    assert st["ok_agree"] >= 0.995 and st["max_disagree_margin"] <= 1e-3, st
    assert st["max_flow_err"] <= 2e-2 and st["share_within_1e-3"] >= 0.99, st
    assert st["n_both_ok"] > 0


def _fleet_levels(device, half_win: int, a: int) -> list:
    """K2's inputs at a fleet of ``a`` agents on 480x640 orbit frames, level
    by level, coarsest first: the slots the tracker fills on frame 0 (its
    detected corners, 200 an agent), tracked into frame 1, each level's
    guess from the plain version's result on the coarser level. Returns
    [(args, the plain version's (flow, ok))]."""
    from x_multi_agent_torch.utils.bench import orbit_frames
    from x_multi_agent_torch.vision import tracker
    from x_multi_agent_torch.vision.image import build_pyramid

    h, w = 480, 640
    tp = configs.flagship_tracker(200)
    frames, _ = orbit_frames(a, 2, h, w, device)
    st, _ = tracker.track_frame_batch(tp, configs.flagship_camera(h, w),
                                      tracker.TrackerState.zero(tp, a, h, w, device=device),
                                      frames[0])
    pyr0, pyr1 = (build_pyramid(f, tp.lk_max_level) for f in frames)
    out, flow = [], torch.zeros_like(st.pts)
    for lvl in range(len(pyr0) - 1, -1, -1):
        dx, dy = scharr_gradients(pyr0[lvl])
        flow = (flow * 2.0 if lvl < len(pyr0) - 1 else flow).contiguous()
        args = (pyr0[lvl].contiguous(), pyr1[lvl].contiguous(), dx.contiguous(),
                dy.contiguous(), (st.pts / 2.0**lvl).contiguous(), flow, half_win, tp.lk_iters,
                tp.min_eig_thr)
        out.append((args, lk._track_level(*args)))
        flow = out[-1][1][0]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("agents,where_stable", [(16, False), (64, True)])
@pytest.mark.parametrize("half_win", [10, 15])
def test_lk_kernel_matches_plain_at_the_image_fleet(cuda, half_win, agents, where_stable):
    """K2 on a fleet's three pyramid levels (:func:`_fleet_levels`) under
    :func:`test_lk_kernel_matches_plain`'s gate, at the flagship tracker's
    window (half_win 10) and the largest (15), at 16 agents and at the
    image cell's 64. At 64 the flows are compared where
    ``lk.flow_sensitivity`` finds them stable (ROADMAP C5), and those are
    at least 95 % of the flows both versions track; the ``ok`` flags
    everywhere."""
    for args, (f_ref, ok_ref) in _fleet_levels(cuda, half_win, agents):
        flow, ok = lk.track_level(*args)
        margin = lk.gate_margin(*args[2:5], half_win, args[8])
        stable = lk.flow_sensitivity(*args)[1] <= 1e-3 if where_stable else None
        st = lk.level_agreement(f_ref, ok_ref, flow, ok, margin, compare=stable)
        assert st["ok_agree"] >= 0.995 and st["max_disagree_margin"] <= 1e-3, st
        assert st["max_flow_err"] <= 2e-2 and st["share_within_1e-3"] >= 0.99, st
        assert st["n_both_ok"] > 0, st
        if where_stable:
            both = ok & ok_ref
            assert int((both & stable).sum()) >= 0.95 * int(both.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("half_win", [10, 15])
def test_lk_kernel_edge_band_matches_plain(cuda, half_win):
    """Features over the image and a 25-px band around it, with 1-px
    guesses: windows partly on the replicated edge, where the slab-base
    clamp engages while the Gauss-Newton steps move."""
    rng = np.random.default_rng(3)
    prev, cur = _textured(rng, 2, 96, 160)
    prev, cur = torch.from_numpy(prev).to(cuda), torch.from_numpy(cur).to(cuda)
    dx, dy = scharr_gradients(prev)
    pts = rng.uniform([-25, -25], [185, 121], size=(2, 64, 2))
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    guess = torch.from_numpy(rng.normal(size=(2, 64, 2)).astype(np.float32)).to(cuda)
    args = (prev, cur, dx, dy, pts, guess, half_win, 10, 1e-4)
    before = lk.K2.launches
    flow, ok = lk.track_level(*args)
    torch.cuda.synchronize()
    assert lk.K2.launches == before + 1
    f_ref, ok_ref = lk._track_level(*args)
    margin = lk.gate_margin(dx, dy, pts, half_win, 1e-4)
    # the witness: the plain version in float64, and how far its flow moves
    # when a point moves by 1e-5 px. Where it moves by more than 1e-3 px the
    # steps run away along the replicated edge and no float32 version fixes
    # the flow: compare ok flags there, flows only where the flow is stable
    flow64, sens = lk.flow_sensitivity(*args)
    stable = sens <= 1e-3
    st = lk.level_agreement(f_ref, ok_ref, flow, ok, margin, compare=stable)
    assert st["ok_agree"] >= 0.995 and st["max_disagree_margin"] <= 1e-3, st
    assert st["max_flow_err"] <= 2e-2 and st["share_within_1e-3"] >= 0.99, st
    assert st["n_both_ok"] >= 64, st
    both = ok & ok_ref & stable
    assert float(torch.linalg.norm(flow.double() - flow64, dim=-1)[both].max()) <= 2e-2


@pytest.mark.gpu
def test_kernels_find_nothing_on_a_black_frame(cuda):
    """A black frame (a camera outage): K1 scores no pixel, K2 tracks no
    feature and gives finite flows, as their plain versions do."""
    imgs = torch.zeros((1, 480, 640), device=cuda)
    score = fast.fast_score_nms(imgs, 12.0)
    assert float(score.abs().max()) == 0.0
    dx, dy = scharr_gradients(imgs)
    pts = torch.from_numpy(np.random.default_rng(6).uniform(
        [20, 20], [620, 460], size=(1, 200, 2)).astype(np.float32)).to(cuda)
    args = (imgs, imgs, dx, dy, pts, torch.zeros_like(pts), 10, 10, 1e-4)
    flow, ok = lk.track_level(*args)
    f_ref, ok_ref = lk._track_level(*args)
    assert not bool(ok.any()) and not bool(ok_ref.any())
    assert bool(torch.isfinite(flow).all())


@pytest.mark.gpu
def test_kernels_reject_bad_operands(cuda):
    imgs = torch.zeros((1, 32, 32), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        fast.fast_score_nms(imgs, 12.0)
    img = torch.zeros((1, 32, 32), device=cuda)
    pts = torch.zeros((1, 4, 2), device=cuda)
    with pytest.raises(ValueError):
        lk.track_level(img, img, img, img[:, :, :16].contiguous(), pts, pts, 10, 10, 1e-4)


@pytest.mark.gpu
def test_round_and_facade_reject_tf32(cuda):
    """The collaborative round and the facade's entries on a CUDA device
    raise while TF32 matmuls are on, before any state is touched."""
    params = _collab_params("float32")
    fs, _ = vio.init_at_time(params, 0.0, 2, cuda)
    v = vio.VIO(params, device=cuda)
    v.init_at_time(0.0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="TF32"):
            collab.collaborative_round(params, collab.CollabConfig(), fs)
        for call in (lambda: v.process_imu(0.01, 0, np.zeros(3), np.zeros(3)),
                     lambda: v.process_matches_measurement(
                         0.01, 0, tm.Matches.zero(params.cfg.tracks, 1, device=cuda))):
            with pytest.raises(ValueError, match="TF32"):
                call()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
def test_frame_step_rejects_tf32(cuda):
    from x_multi_agent_torch.vio.frame_step import frame_step

    imgs = torch.zeros((1, 32, 32), device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="TF32"):
            frame_step(None, None, None, None, None, None, imgs, *([None] * 5))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 480, 640), (1, 240, 320)])
def test_fast_kernel_single_agent_matches_plain(cuda, shape):
    """K1 at A = 1, the single-agent facade's detection shapes: exact."""
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.integers(0, 255, size=shape).astype(np.float32)).to(cuda)
    before = fast.K1.launches
    got = fast.fast_score_nms(imgs, 12.0)
    torch.cuda.synchronize()
    assert fast.K1.launches == before + 1
    torch.testing.assert_close(got, fast.nms3(fast.fast_score(imgs, 12.0)), rtol=0, atol=0)


def _facade_detect_shapes(monkeypatch, device):
    """Drive the single-agent facade's image path for one frame and return
    the shapes its FAST dispatch saw, and the K1 launches it made."""
    shapes = []
    plain_dispatch = fast.fast_score_nms

    def spy(imgs, *args, **kwargs):
        shapes.append(tuple(imgs.shape))
        return plain_dispatch(imgs, *args, **kwargs)

    monkeypatch.setattr(fast, "fast_score_nms", spy)
    h, w = 120, 160
    params = configs.flagship_params(small=True)
    v = vio.VIO(params, device=device)
    v.init_at_time(0.0)
    v.setup_tracker(configs.flagship_tracker(params.cfg.tracks.n_matches),
                    configs.flagship_camera(h, w), h, w)
    img, _ = _textured(np.random.default_rng(5), 1, h, w)
    before = fast.K1.launches
    v.process_image_measurement(0.05, 0, img[0])
    return shapes, fast.K1.launches - before


def test_facade_reaches_fast_dispatch_with_one_agent(monkeypatch):
    """On the CPU the facade's frame reaches K1's dispatch with a (1, H, W)
    batch and runs the plain version (no launch)."""
    shapes, launched = _facade_detect_shapes(monkeypatch, torch.device("cpu"))
    assert (1, 120, 160) in shapes and launched == 0


@pytest.mark.gpu
def test_facade_launches_fast_kernel_with_one_agent(cuda, monkeypatch):
    shapes, launched = _facade_detect_shapes(monkeypatch, cuda)
    assert (1, 120, 160) in shapes and launched >= 1


def _collab_params(dtype: str) -> vio.VioParams:
    """The reference's two-agent collaboration test configuration
    (``tests/test_collab.py``), stated here without importing JAX."""
    dims = StateDims(n_poses=8, n_features=8, buffer_size=64)
    tracks = tm.TrackDims(n_slam=8, n_poses=8, n_opp=40, n_matches=60, n_msckf=8, n_short=6,
                          n_new_slam=8)
    cfg = pipeline.VioConfig(dims=dims, tracks=tracks, sigma_img=2e-3, min_track_length=5,
                             msckf_baseline_x_n=0.01, msckf_baseline_y_n=0.01,
                             obs_constrained=False)
    return vio.VioParams(cfg=cfg, dtype=dtype, max_update_lag=32, sigma_dv=(0.05,) * 3,
                         sigma_dtheta_deg=(1.0,) * 3, sigma_dbw_deg=(1.0,) * 3,
                         sigma_dba=(0.05,) * 3)


@pytest.fixture(scope="module")
def two_agents():
    """Two port agents (B 0.25 m off under a loose prior) driven 1.5 s
    through the facade on the CPU in float64, stacked."""
    from x_multi_agent_tpu.utils.sim import make_circle_sim  # numpy only

    params = _collab_params("float64")
    sim = make_circle_sim(duration=1.5, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                          match_budget=60, pixel_noise=5e-4, seed=1)
    agents = []
    for offset, sigma_dp in (((0.0, 0.0, 0.0), 1e-3), ((0.25, 0.0, 0.0), 0.5)):
        v = vio.VIO(params._replace(sigma_dp=(sigma_dp,) * 3), device="cpu")
        v.init_at_time(0.0, p=np.asarray(offset), v=np.array([1.8, 0.0, 0.0]))
        imu_i = 0
        for f, t_cam in enumerate(sim.cam_t):
            while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
                v.process_imu(sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i])
                imu_i += 1
            v.process_matches_measurement(t_cam, f, tm.Matches.of(
                track_id=torch.from_numpy(sim.match_id[f])[None],
                prev_pt=torch.from_numpy(sim.match_prev[f])[None],
                cur_pt=torch.from_numpy(sim.match_cur[f])[None],
                valid=torch.from_numpy(sim.match_valid[f])[None]))
        agents.append(v.fs)
    return tree.cat(agents)


@pytest.mark.gpu
def test_collaborative_round_cuda_matches_cpu(cuda, two_agents):
    """The round on the card in float32 against the CPU in float64, same
    inputs: the fused counts exactly; covariance within 1e-4 of its max,
    buffer and window states within 1e-4 (on the CPU float32 is within
    ~5e-6 relative of float64 here)."""
    fs = two_agents
    ccfg = collab.CollabConfig(sigma_landmark=0.1, ci_slam_w=0.05, gt_match_dist=0.6,
                               match_budget=8)
    ref_fs, ref_n = collab.collaborative_round(_collab_params("float64"), ccfg, fs)
    fs32 = tree.map_leaves(lambda x: (x.float() if x.is_floating_point() else x).to(cuda), fs)
    got_fs, got_n = collab.collaborative_round(_collab_params("float32"), ccfg, fs32)
    torch.cuda.synchronize()
    assert torch.equal(got_n.cpu(), ref_n) and int(ref_n.sum()) > 0
    cov_scale = float(ref_fs.cov.abs().max())
    assert float((got_fs.cov.cpu().double() - ref_fs.cov).abs().max()) <= 1e-4 * cov_scale
    assert float((got_fs.buffer.cpu().double() - ref_fs.buffer).abs().max()) <= 1e-4
    for name in ("p_arr", "q_arr", "f_arr"):
        got = getattr(got_fs.vision, name).cpu().double()
        assert float((got - getattr(ref_fs.vision, name)).abs().max()) <= 1e-4, name


@pytest.mark.gpu
def test_collaborative_round_never_waits_for_the_card(cuda, two_agents):
    """After a first round has built the per-device constants, a round runs
    no synchronizing CUDA operation (sync debug mode "error" raises on one)."""
    fs = tree.map_leaves(lambda x: (x.float() if x.is_floating_point() else x).to(cuda), two_agents)
    params, ccfg = _collab_params("float32"), collab.CollabConfig()
    collab.collaborative_round(params, ccfg, fs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        collab.collaborative_round(params, ccfg, fs)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# the reference tests' descriptor setting (test_request_comm_loop.py:35-38)
DESC_CCFG = collab.CollabConfig(sigma_landmark=0.1, ci_slam_w=0.05, gt_match_dist=0.6,
                                match_budget=8, desc_ratio_thr=0.9, desc_abs_thr=40.0,
                                pr_score_thr=0.2)


# the keyed draws are integer hashes: the same bits on either device for the
# same mask and keys
_KEYED = KeyedSampler()


@pytest.fixture(scope="module")
def desc_fleet():
    """Three port agents (the second 0.25 m off under a loose prior, the
    third 0.1 m off) driven 1.5 s through the facade on the CPU in float64,
    with descriptors from a random table keyed by track id; stacked (fs,
    slots), 16 words, and each agent's keyframe ring holding its own
    snapshot and its next peer's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from x_multi_agent_tpu.utils.sim import make_circle_sim  # numpy only

    params = _collab_params("float64")
    desc_table = np.random.default_rng(11).integers(0, 256, (40, 32)).astype(np.uint8)
    sim = make_circle_sim(duration=1.5, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                          match_budget=60, pixel_noise=5e-4, seed=1)
    fss, slotss = [], []
    for offset, sigma_dp in (((0.0, 0.0, 0.0), 1e-3), ((0.25, 0.0, 0.0), 0.5),
                             ((0.0, 0.1, 0.0), 0.1)):
        v = vio.VIO(params._replace(sigma_dp=(sigma_dp,) * 3), device="cpu")
        v.init_at_time(0.0, p=np.asarray(offset), v=np.array([1.8, 0.0, 0.0]))
        imu_i = 0
        for f, t_cam in enumerate(sim.cam_t):
            while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
                v.process_imu(sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i])
                imu_i += 1
            ids = np.clip(sim.match_id[f], 0, len(desc_table) - 1)
            v.process_matches_measurement(t_cam, f, tm.Matches.of(
                track_id=torch.from_numpy(sim.match_id[f])[None],
                prev_pt=torch.from_numpy(sim.match_prev[f])[None],
                cur_pt=torch.from_numpy(sim.match_cur[f])[None],
                valid=torch.from_numpy(sim.match_valid[f])[None],
                desc=torch.from_numpy(desc_table[ids])[None],
                desc_valid=torch.from_numpy(sim.match_valid[f])[None]))
        fss.append(v.fs)
        slotss.append(v.slots)
    fs, slots = tree.cat(fss), tree.cat(slotss)
    rng = np.random.default_rng(12)
    words = torch.from_numpy(
        train_kmajority(rng.integers(0, 256, (400, 32)).astype(np.uint8), 16, 5).words)
    own = collab.extract_payload_desc(params, fs, slots)
    peer = tree.map_leaves(lambda x: x[(torch.arange(3) + 1) % 3], own)
    dd = db_mod.DbDims(n_keyframes=3, n_words=16, max_agents=4)
    db = db_mod.add_keyframe(dd, db_mod.add_keyframe(dd, db_mod.KeyframeDB.zero(dd, own), own,
                                                     words), peer, words)
    return fs, slots, words, dd, db


def _to_card(x, device):
    return tree.map_leaves(lambda v: (v.float() if v.is_floating_point() else v).to(device), x)


@pytest.mark.gpu
def test_request_response_round_cuda_matches_cpu(cuda, desc_fleet):
    """The request-response round on the card in float32 against the CPU in
    float64, same inputs and RANSAC draws: hits, fused counts and the
    keyframe rings exactly; covariance within 1e-4 of its max, buffer and
    window states within 1e-4."""
    fs, slots, words, _, db = desc_fleet
    ref = collab.request_response_round(_collab_params("float64"), DESC_CCFG, words, fs, slots,
                                        db, sampler=_KEYED)
    got = collab.request_response_round(
        _collab_params("float32"), DESC_CCFG, words.to(cuda), _to_card(fs, cuda),
        _to_card(slots, cuda), _to_card(db, cuda), sampler=_KEYED)
    torch.cuda.synchronize()
    ref_fs, ref_db, ref_hits, ref_n = ref
    got_fs, got_db, got_hits, got_n = got
    assert torch.equal(got_hits.cpu(), ref_hits) and bool(ref_hits.any())
    assert torch.equal(got_n.cpu(), ref_n) and int(ref_n.sum()) > 0
    for name in ("served", "valid", "wptr", "vlad"):
        assert torch.equal(getattr(got_db, name).cpu(), getattr(ref_db, name)), name
    cov_scale = float(ref_fs.cov.abs().max())
    assert float((got_fs.cov.cpu().double() - ref_fs.cov).abs().max()) <= 1e-4 * cov_scale
    assert float((got_fs.buffer.cpu().double() - ref_fs.buffer).abs().max()) <= 1e-4
    for name in ("p_arr", "q_arr", "f_arr"):
        g = getattr(got_fs.vision, name).cpu().double()
        assert float((g - getattr(ref_fs.vision, name)).abs().max()) <= 1e-4, name


@pytest.mark.gpu
def test_request_comm_rounds_never_wait_for_the_card(cuda, desc_fleet):
    """After a first pass has built the per-device constants, the fleet's
    collaboration step (a request-response round with the keyed RANSAC
    draws, a joint-MSCKF round, the keyframe step) runs no synchronizing
    CUDA operation (sync debug mode "error" raises on one)."""
    fs, slots, words, dd, db = desc_fleet
    fs, slots, db, words = (_to_card(x, cuda) for x in (fs, slots, db, words))
    params = _collab_params("float32")

    def step():
        f, d, _, _ = collab.request_response_round(params, DESC_CCFG, words, fs, slots, db)
        f, _ = collab.collaborative_msckf_round(params, DESC_CCFG, f, slots)
        kf = collab.KfMeta.zero(3, torch.float32, cuda)
        collab.maybe_add_keyframe(params, dd, words, f, slots, d, kf,
                                  enabled=torch.ones((3,), dtype=torch.bool, device=cuda))

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_track_rows_cpu_tensors_use_plain_chain():
    before = track_rows.TRACK_ROWS.launches
    finite, reflect = track_rows.COV_FINITE.launches, track_rows.REFLECT.launches
    obs, mask, q, p, cov = rows_in.window(0, 2, 6, 6, 4)
    msckf.build(obs, mask, q, p, cov, rows_in.SIGMA_IMG, 4)
    msckf_slam.build(obs, mask, q, p, cov, rows_in.SIGMA_IMG, 4)
    slam.build(*rows_in.slam(0, 2, 6, 4), rows_in.SIGMA_IMG)
    assert track_rows.TRACK_ROWS.launches == before
    assert track_rows.COV_FINITE.launches == finite and track_rows.REFLECT.launches == reflect


def _spy(monkeypatch, name):
    """Record the operands the builders hand to ``track_rows.<name>``."""
    calls, fn = [], getattr(track_rows, name)

    def spy(*args):
        calls.append(args)
        return fn(*args)

    monkeypatch.setattr(track_rows, name, spy)
    return calls


def _gate_margin(gamma, thr):
    """Tracks whose gamma lies within 1e-4 relative of its threshold: there a
    rounding of the sums may flip the gate either way."""
    return torch.abs(gamma - thr) <= 1e-4 * torch.abs(thr)


# Tolerances of the kernel against the plain chain on the same operands. The
# kernel sums each reflection's 2M-term dot products serially and each
# product of S over the pose columns in its own order, where the plain chain
# goes through cuBLAS: float32 results differ by a few ulp of the sums' terms
# (~1e-6 of a leaf's largest magnitude at 2M = 30), so 1e-4; float64 1e-10.
_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def _close_on(got, ref, scale, tol, where):
    """Leaves within ``tol`` of ``scale`` on the tracks ``where`` (A, K)."""
    w = where.reshape(where.shape + (1,) * (ref.dim() - where.dim()))
    diff = float(torch.where(w, (got - ref).abs(), 0.0).max())
    assert diff <= tol * float(scale), (diff, float(scale))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,k", [(15, 15, 15), (10, 10, 10)])
def test_track_rows_window_kernel_matches_plain(cuda, monkeypatch, dtype, m, n, k):
    """MSCKF and MSCKF-SLAM rows, residuals, h1, h2, r1 and gate decisions of
    the kernel against the plain chain run on the card on the same operands,
    with a NaN in one agent's P (all its tracks rejected, as the plain chain
    rejects them) and an indefinite P in another (S does not factorize)."""
    obs, mask, q, p, cov = (x.to(cuda) for x in rows_in.window(7 + m, 3, k, m, n, edge=True,
                                                                 dtype=dtype))
    calls = _spy(monkeypatch, "window_rows")
    before, finite = track_rows.TRACK_ROWS.launches, track_rows.COV_FINITE.launches
    msckf.build(obs, mask, q, p, cov, rows_in.SIGMA_IMG, n)
    msckf_slam.build(obs, mask, q, p, cov, rows_in.SIGMA_IMG, n)
    assert track_rows.TRACK_ROWS.launches == before + 2
    assert track_rows.COV_FINITE.launches == finite + 2  # one finiteness pass a launch
    tol = _TOL[dtype]
    for args in list(calls):  # the spy records the calls below too
        res, n_obs = args[0], args[6]
        got = track_rows.window_rows(*args)
        ref = track_rows._window_plain(*args)
        _, _, gamma, _ = track_rows._window_dense(*args[:6], *args[8:])
        thr = track_rows.chi2_quantile_table(0.95, 2 * m, dtype, cuda)[
            torch.clamp(2 * n_obs - 3, 0, 2 * m)]
        # the gate agrees off its margin; where S does not factorize (a NaN
        # gamma) or nearly so (gamma above 1e8), only the kept flag is held
        assert bool(((got[2] == ref[2]) | _gate_margin(gamma, thr)).all())
        sure = torch.isfinite(gamma) & (gamma.abs() < 1e8)
        assert bool(((got[3] == ref[3]) | ~sure).all())
        assert not got[2][1].any() and not got[3][1].any() and not ref[3][1].any()
        assert bool(torch.isnan(gamma[2]).any()) and bool(got[2][0].sum() >= k - 4)
        both = got[2] & ref[2]
        _close_on(got[0], ref[0], ref[0].abs().max(), tol, both)
        _close_on(got[1], ref[1], ref[1].abs().max(), tol, both)
        assert not torch.where(~got[2][..., None, None], got[0], 0.0).any()
        assert not torch.where(~got[2][..., None], got[1], 0.0).any()
        if ref[4] is not None:  # MSCKF-SLAM's h1, h2, r1, unmasked
            every = torch.ones_like(got[2])
            h1, h2, r1 = ref[4]
            _close_on(got[4][0], h1, h1.abs().max(), tol, every)
            _close_on(got[4][1], h2, h2.abs().max(), tol, every)
            # r1 (the residual along the feature) is ~0: its residuals' scale
            _close_on(got[4][2], r1, res.abs().max(), tol, every)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(15, 15), (10, 10)])
def test_track_rows_slam_kernel_matches_plain(cuda, monkeypatch, dtype, m, n):
    """SLAM rows and gate decisions of the kernel against the plain chain
    on the card: the special rows (anchor at the current pose), an empty
    anchor slot, the non-finite and the indefinite P. A kept feature's rows
    and residual are copies of its blocks, so they are held exactly."""
    args = [x.to(cuda) if isinstance(x, torch.Tensor) else x
            for x in rows_in.slam(3 + m, 3, m, n, edge=True, dtype=dtype)]
    calls = _spy(monkeypatch, "slam_rows")
    before, finite = track_rows.TRACK_ROWS.launches, track_rows.COV_FINITE.launches
    slam.build(*args, rows_in.SIGMA_IMG)
    assert track_rows.TRACK_ROWS.launches == before + 1
    assert track_rows.COV_FINITE.launches == finite + 1
    ops = calls[0]
    got = track_rows.slam_rows(*ops)
    ref = track_rows._slam_plain(*ops)
    _, gamma = track_rows._slam_dense(*ops[:10])
    thr = track_rows.chi2_quantile_table(0.90, 2 * ops[12], dtype, cuda)[
        torch.clamp(2 * ops[10], 0, 2 * ops[12])]
    kept = [(x[0].reshape(3, n, 2, -1) != 0).any(-1).any(-1) for x in (got, ref)]
    assert bool(((kept[0] == kept[1]) | _gate_margin(gamma, thr)).all())
    # agents 0 and 1: the special rows kept; the empty slot, the outlier and
    # track length 0 rejected; every feature of the agent with a NaN in P
    assert kept[0][0, 0] and not kept[0][1].any() and not kept[0][:2, 1:4].any()
    both = kept[0] & kept[1]
    _close_on(got[0].reshape(3, n, 2, -1), ref[0].reshape(3, n, 2, -1), 1.0, 0.0, both)
    _close_on(got[1].reshape(3, n, 2), ref[1].reshape(3, n, 2), 1.0, 0.0, both)


@pytest.mark.gpu
def test_track_rows_rejects_bad_operands(cuda, monkeypatch):
    obs, mask, q, p, cov = (x.to(cuda) for x in rows_in.window(0, 2, 4, 3, 3))
    with pytest.raises(ValueError, match="4 <= M <= 16"):
        msckf.build(obs, mask, q, p, cov, rows_in.SIGMA_IMG, 3)
    obs, mask, q, p, cov = (x.to(cuda) for x in rows_in.window(0, 2, 4, 6, 3,
                                                                 dtype=torch.float32))
    calls = _spy(monkeypatch, "window_rows")
    msckf.build(obs, mask, q, p, cov, rows_in.SIGMA_IMG, 3)
    args = list(calls[0])
    args[4] = args[4].double()  # blocks float32, covariance float64
    with pytest.raises(ValueError, match="expected torch.float64"):
        track_rows.window_rows(*args)


def _bit_for_bit(cuda, monkeypatch, agents):
    """The kernel's window rows against the plain chain's at ``agents`` x 15
    tracks, float32: equal bit for bit on the tracks both keep."""
    obs, mask, q, p, cov = (x.to(cuda) for x in rows_in.window(5, agents, 15, 15, 15,
                                                                 dtype=torch.float32))
    calls = _spy(monkeypatch, "window_rows")
    msckf.build(obs, mask, q, p, cov, rows_in.SIGMA_IMG, 15)
    msckf_slam.build(obs, mask, q, p, cov, rows_in.SIGMA_IMG, 15)
    why = (f"at {agents} x 15 tracks the kernel's rows differ from the plain chain's: cuBLAS "
           "no longer sums the plain chain's v^T a in row order at this batch, which the "
           "kernel's rounding copies (ROADMAP D6)")
    for args in list(calls):
        got = track_rows.window_rows(*args)
        ref = track_rows._window_plain(*args)
        both = got[2] & ref[2]
        assert int(both.sum()) >= agents * 10
        assert torch.equal(got[0][both], ref[0][both]), why
        assert torch.equal(got[1][both], ref[1][both]), why
        if ref[4] is not None:
            for g, r in zip(got[4], ref[4]):
                assert torch.equal(g, r), why


@pytest.mark.gpu
def test_track_rows_bit_for_bit_at_the_image_fleet(cuda, monkeypatch):
    """At the image cell's 64 agents x 15 tracks (and larger batches) cuBLAS
    sums the plain chain's v^T a in row order, and the kernel rounds each
    step as the plain chain does: the rows, residuals and MSCKF-SLAM's
    h1, h2, r1 of the tracks both keep equal the plain chain's bit for bit
    (what keeps the benchmark's filter step on its plain reference's knife
    edges, such as the Gram compression's Cholesky)."""
    _bit_for_bit(cuda, monkeypatch, 64)


@pytest.mark.gpu
def test_track_rows_bit_for_bit_at_the_512_agent_fleet(cuda, monkeypatch):
    """The same at the 512-agent cell's 512 x 15 tracks: fails loudly where a
    cuBLAS or torch release sums v^T a in another order at that batch."""
    _bit_for_bit(cuda, monkeypatch, 512)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("a", [1, 64, 512])
def test_track_reflect_kernel_is_householder_qt(cuda, dtype, a):
    """The card's reflections (``track_reflect`` between torch's v^T hf
    products) against householder_qt's own operations on the card, bit for
    bit, on dense rows and on rows with an unobserved tail and with no
    feature Jacobian at all."""
    g = torch.Generator(device=cuda).manual_seed(a)
    hf = torch.randn(a, 15, 30, 3, generator=g, device=cuda, dtype=dtype)
    res = torch.randn(a, 15, 30, generator=g, device=cuda, dtype=dtype)
    hf[:, 1, 20:] = res[:, 1, 20:] = 0.0
    hf[:, 2] = 0.0
    before = track_rows.REFLECT.launches
    got = track_rows._reflections(hf, res)
    assert track_rows.REFLECT.launches == before + 4
    ref = track_rows._reflections_plain(hf, res)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
