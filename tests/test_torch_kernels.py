"""The hand-written CUDA kernels (K1 FAST, K2 LK level) against their plain
PyTorch versions, and the card's float32 collaborative rounds (the full-map
round and the descriptor-driven request-response round) against the CPU's
float64 ones, with no synchronizing operation inside a round.

Tests marked ``gpu`` need a CUDA card and skip without one; they run on the
card with ``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``
(``--noconftest``: the suite's conftest imports JAX, which the card's machine
does not have; nothing here imports it). The CPU tests check the dispatch
rule: a CPU tensor goes to the plain version and leaves the launch counter
as it was.
"""
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from x_multi_agent_torch import configs
from x_multi_agent_torch.ekf.state import StateDims
from x_multi_agent_torch.ops.ransac import draw_sample_indices, generator_sampler
from x_multi_agent_torch.parallel import collab
from x_multi_agent_torch.place_recognition import database as db_mod
from x_multi_agent_torch.place_recognition.vocabulary import train_kmajority
from x_multi_agent_torch.utils import tree
from x_multi_agent_torch.vio import pipeline
from x_multi_agent_torch.vio import track_manager as tm
from x_multi_agent_torch.vio import vio
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
@pytest.mark.parametrize("shape", [(3, 77, 133), (2, 120, 160)])
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
        v = vio.VIO(params._replace(sigma_dp=(sigma_dp,) * 3))
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


def _cpu_sampler(mask, seed, t, k):
    """RANSAC sample indices drawn on the CPU from ``seed`` alone: the same
    draws on either device for the same mask."""
    g = torch.Generator().manual_seed(seed)
    return draw_sample_indices(mask.cpu(), 200, g).to(mask.device)


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
        v = vio.VIO(params._replace(sigma_dp=(sigma_dp,) * 3))
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
                                        db, sampler=_cpu_sampler)
    got = collab.request_response_round(
        _collab_params("float32"), DESC_CCFG, words.to(cuda), _to_card(fs, cuda),
        _to_card(slots, cuda), _to_card(db, cuda), sampler=_cpu_sampler)
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
    collaboration step (a request-response round with the card's own RANSAC
    draws, a joint-MSCKF round, the keyframe step) runs no synchronizing
    CUDA operation (sync debug mode "error" raises on one)."""
    fs, slots, words, dd, db = desc_fleet
    fs, slots, db, words = (_to_card(x, cuda) for x in (fs, slots, db, words))
    params = _collab_params("float32")
    sampler = generator_sampler(torch.Generator(device=cuda).manual_seed(0))

    def step():
        f, d, _, _ = collab.request_response_round(params, DESC_CCFG, words, fs, slots, db,
                                                   sampler=sampler)
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
