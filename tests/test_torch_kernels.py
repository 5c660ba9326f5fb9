"""The hand-written CUDA kernels (K1 FAST, K2 LK level) against their plain
PyTorch versions.

Tests marked ``gpu`` need a CUDA card and skip without one; they run on the
card with ``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``
(``--noconftest``: the suite's conftest imports JAX, which the card's machine
does not have). The CPU tests check the dispatch rule: a CPU tensor goes to
the plain version and leaves the launch counter as it was.
"""
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

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
def test_frame_step_rejects_tf32(cuda):
    from x_multi_agent_torch.vio.frame_step import frame_step

    imgs = torch.zeros((1, 32, 32), device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="TF32"):
            frame_step(None, None, None, None, None, None, imgs, *([None] * 5))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
