"""The filter's three row builders on CPU tensors (``msckf.build``,
``msckf_slam.build``, ``slam.build``, whose tail is
``vio/updates/track_rows.py``): equal bit for bit to the dense chain they
ran before the card got its kernel (the functions ``_chain_*`` below, that
chain verbatim), and to the JAX package's builders as the rest of the suite
holds them (float64, 1e-9 of each leaf's largest magnitude: the reference
solves S by Newton-Schulz where the port factors it; gate decisions
exactly). At the flagship shapes (M = N = 15, K = 15) and at M = N = 10,
with masked tracks, tracks with fewer than 2 observations, an outlier, a
covariance with a NaN outside the pose block and one on which S does not
factorize (``track_rows_inputs.py``). The kernel itself is held to this
plain chain on the card (``test_torch_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import track_rows_inputs as inputs
from x_multi_agent_torch.ops import lie, linalg, triangulation
from x_multi_agent_torch.utils.chi2 import chi2_gate
from x_multi_agent_torch.utils.const import constant
from x_multi_agent_torch.vio.updates import msckf, msckf_slam, slam, track_rows
from x_multi_agent_torch.vio.updates.common import (feature_col, pose_att_col, pose_pos_col,
                                                     projection_blocks, scatter_block)
from x_multi_agent_tpu.vio.updates import msckf as jmsckf
from x_multi_agent_tpu.vio.updates import msckf_slam as jmsckf_slam
from x_multi_agent_tpu.vio.updates import slam as jslam

SHAPES = [(15, 15, 15), (10, 10, 10)]  # (M, N, K)
SIGMA = inputs.SIGMA_IMG


def _chain_msckf(obs, mask, q_arr, p_arr, cov, sigma_img, n_features):
    a, k, m, _ = obs.shape
    dtype, dev = cov.dtype, cov.device
    d = cov.shape[-1]
    g_vec = constant(msckf.GRAVITY, dtype, dev)
    n_obs = torch.sum(mask, dim=-1)
    enough = n_obs >= 2
    ivd, anchor = triangulation.triangulate_gn(obs, mask, q_arr, p_arr, 10, 1e-5)
    ar = torch.arange(a, device=dev)[:, None]
    g_p_f = triangulation.ivd_to_world(ivd, q_arr[ar, anchor.long()], p_arr[ar, anchor.long()])
    res, j_pos, j_att, hf, finite = msckf._obs_jacobians(g_p_f, obs, mask, q_arr, p_arr, g_vec,
                                                         True)
    h_j = track_rows._assemble_h(j_pos, j_att, m, n_features)
    h0, res0, _, _ = linalg.nullspace_project(
        hf.reshape(a, k, 2 * m, 3), h_j, res.reshape(a, k, 2 * m)
    )
    gamma = linalg.mahalanobis_gamma(cov[:, None], h0 / sigma_img, res0 / sigma_img)
    inlier = chi2_gate(gamma, 2 * n_obs - 3, 0.95, 2 * m)
    valid = enough & finite & torch.isfinite(gamma)
    keep = inlier & valid
    h0 = torch.where(keep[..., None, None], h0, 0.0)
    res0 = torch.where(keep[..., None], res0, 0.0)
    rows = k * (2 * m - 3)
    return (h0.reshape(a, rows, d), res0.reshape(a, rows), ivd, anchor, g_p_f, keep, valid,
            gamma)


def _chain_msckf_slam(obs, mask, q_arr, p_arr, cov, sigma_img, n_features):
    a, k, m, _ = obs.shape
    dtype, dev = cov.dtype, cov.device
    d = cov.shape[-1]
    n_obs = torch.sum(mask, dim=-1)
    enough = n_obs >= 2
    ivd, anchor = triangulation.triangulate_gn(obs, mask, q_arr, p_arr, 10, 1e-5)
    alpha, beta, rho = ivd[..., 0], ivd[..., 1], ivd[..., 2]
    safe_rho = torch.where(torch.abs(rho) > 1e-12, rho, torch.ones_like(rho))
    ar = torch.arange(a, device=dev)[:, None]
    q_a = q_arr[ar, anchor.long()]
    p_a = p_arr[ar, anchor.long()]
    r_wa = lie.quat_to_rot(q_a)
    bearing = torch.stack([alpha, beta, torch.ones_like(alpha)], dim=-1)
    g_p_f = (r_wa @ bearing[..., None])[..., 0] / safe_rho[..., None] + p_a
    r_cw = lie.quat_to_rot(q_arr)[:, None].transpose(-1, -2)
    is_last = torch.arange(m, device=dev) == anchor[..., None]
    pt_cam = (r_cw @ (g_p_f[:, :, None] - p_arr[:, None])[..., None])[..., 0]
    j_i, pred, ok = projection_blocks(pt_cam)
    res = obs - pred
    j_pos = -j_i @ r_cw
    j_att = j_i @ lie.skew(pt_cam)
    r_wa_o = r_wa[:, :, None]
    rho_o = safe_rho[..., None, None, None]
    j_anchor_att = -1.0 / rho_o * j_i @ r_cw @ r_wa_o @ lie.skew(bearing)[:, :, None]
    j_anchor_pos = -j_pos
    mat = msckf_slam._inv_depth_jac(alpha, beta, safe_rho)[:, :, None]
    hf = (1.0 / rho_o) * j_i @ r_cw @ r_wa_o @ mat
    hf_last = torch.eye(3, dtype=dtype, device=dev)[:2]
    last = is_last[..., None, None]
    j_pos = torch.where(last, 0.0, j_pos)
    j_att = torch.where(last, 0.0, j_att)
    j_anchor_pos = torch.where(last, 0.0, j_anchor_pos)
    j_anchor_att = torch.where(last, 0.0, j_anchor_att)
    hf = torch.where(last, hf_last, hf)
    keep = mask[..., None, None]
    res = torch.where(mask[..., None], res, 0.0)
    j_pos, j_att, j_anchor_pos, j_anchor_att, hf = (
        torch.where(keep, x, 0.0) for x in (j_pos, j_att, j_anchor_pos, j_anchor_att, hf)
    )
    finite = (ok | ~mask).all(-1)
    anchor_onehot = is_last.to(dtype)
    h = track_rows._assemble_h(j_pos, j_att, m, n_features, j_anchor_pos, j_anchor_att,
                               anchor_onehot)
    h0, res0, h1, (r1, h2) = linalg.nullspace_project(
        hf.reshape(a, k, 2 * m, 3), h, res.reshape(a, k, 2 * m)
    )
    gamma = linalg.mahalanobis_gamma(cov[:, None], h0 / sigma_img, res0 / sigma_img)
    inlier = (chi2_gate(gamma, 2 * n_obs - 3, 0.95, 2 * m) & enough & finite
              & torch.isfinite(gamma))
    h0 = torch.where(inlier[..., None, None], h0, 0.0)
    res0 = torch.where(inlier[..., None], res0, 0.0)
    rows = k * (2 * m - 3)
    return (h0.reshape(a, rows, d), res0.reshape(a, rows), h1, h2, r1, ivd, inlier, g_p_f,
            anchor, gamma)


def _chain_slam(f_arr, anchor_idx, q_arr, p_arr, z_obs, active, track_length, cov,
                cur_pose_idx, sigma_img, max_track_length=60):
    a, m = q_arr.shape[:2]
    n = f_arr.shape[1]
    d = cov.shape[-1]
    dtype, dev = cov.dtype, cov.device
    r_cw_cur = lie.quat_to_rot(q_arr[:, cur_pose_idx]).transpose(-1, -2)[:, None]
    p_cur = p_arr[:, cur_pose_idx][:, None]
    ar = torch.arange(a, device=dev)[:, None]
    a_idx = anchor_idx.long()
    r_wa = lie.quat_to_rot(q_arr[ar, a_idx])
    p_a = p_arr[ar, a_idx]
    alpha, beta, rho = f_arr[..., 0], f_arr[..., 1], f_arr[..., 2]
    safe_rho = torch.where(torch.abs(rho) > 1e-12, rho, torch.ones_like(rho))
    bearing = torch.stack([alpha, beta, torch.ones_like(alpha)], dim=-1)
    g_p_f = (r_wa @ bearing[..., None])[..., 0] / safe_rho[..., None] + p_a
    pt_cam = (r_cw_cur @ (g_p_f - p_cur)[..., None])[..., 0]
    j_i, pred, finite = projection_blocks(pt_cam)
    res_j = z_obs - pred
    rho_b = safe_rho[..., None, None]
    j_att = j_i @ lie.skew(pt_cam)
    j_pos = -j_i @ r_cw_cur
    j_anchor_att = -1.0 / rho_b * j_i @ r_cw_cur @ r_wa @ lie.skew(bearing)
    j_anchor_pos = -j_pos
    hf = (1.0 / rho_b) * j_i @ r_cw_cur @ r_wa @ msckf_slam._inv_depth_jac(alpha, beta, safe_rho)
    h0 = torch.zeros((a, n, 2, d), dtype=dtype, device=dev)
    feat = torch.arange(n, device=dev)
    h_gen = scatter_block(h0, j_pos, pose_pos_col(cur_pose_idx, m))
    h_gen = scatter_block(h_gen, j_att, pose_att_col(cur_pose_idx, m))
    h_gen = scatter_block(h_gen, j_anchor_pos, pose_pos_col(a_idx, m))
    h_gen = scatter_block(h_gen, j_anchor_att, pose_att_col(a_idx, m))
    h_gen = scatter_block(h_gen, hf, feature_col(feat, m))
    eye_blk = torch.eye(3, dtype=dtype, device=dev)[:2].expand(a, n, 2, 3)
    h_special = scatter_block(h0, eye_blk, feature_col(feat, m))
    h_all = torch.where((anchor_idx == cur_pose_idx)[..., None, None], h_special, h_gen)
    gamma = linalg.mahalanobis_gamma(cov[:, None], h_all / sigma_img, res_j / sigma_img)
    inlier = chi2_gate(gamma, 2 * track_length, 0.90, 2 * max_track_length)
    keep = active & inlier & finite
    h_out = torch.where(keep[..., None, None], h_all, 0.0).reshape(a, 2 * n, d)
    res_out = torch.where(keep[..., None], res_j, 0.0).reshape(a, 2 * n)
    return h_out, res_out, keep, gamma


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(torch.nan_to_num(got, 7.0), torch.nan_to_num(ref, 7.0))
    assert torch.equal(torch.isnan(got), torch.isnan(ref))


def _close(got, ref, scale=None, rel=1e-9):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_msckf_build_equals_the_dense_chain(m, n, k):
    obs, mask, q, p, cov = inputs.window(10 + m, 3, k, m, n, edge=True)
    upd, info = msckf.build(obs, mask, q, p, cov, SIGMA, n)
    ref = _chain_msckf(obs, mask, q, p, cov, SIGMA, n)
    for got, want in zip((upd.jac, upd.res, info.ivd, info.anchor, info.world, info.inlier,
                          info.valid), ref):
        _same(got, want)
    gamma, keep = ref[-1], info.inlier
    # the cases are there: no obs, one obs, the outlier, the NaN P, S not factorized
    assert not keep[:, :2].any() and not keep[0, 2] and keep[0].sum() >= k - 4
    assert not info.valid[1].any() and torch.isnan(gamma[1]).all()
    assert torch.isnan(gamma[2]).any() and keep[2].any()


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_msckf_slam_build_equals_the_dense_chain(m, n, k):
    obs, mask, q, p, cov = inputs.window(20 + m, 3, k, m, n, edge=True)
    upd, init = msckf_slam.build(obs, mask, q, p, cov, SIGMA, n)
    ref = _chain_msckf_slam(obs, mask, q, p, cov, SIGMA, n)
    for got, want in zip((upd.jac, upd.res, init.h1, init.h2, init.r1, init.features,
                          init.inlier, init.world, init.anchor), ref):
        _same(got, want)
    gamma, keep = ref[-1], init.inlier
    assert not keep[:, :2].any() and not keep[0, 2] and keep[0].sum() >= k - 4
    assert not keep[1].any() and torch.isnan(gamma[2]).any()


@pytest.mark.parametrize("m,n", [s[:2] for s in SHAPES])
def test_slam_build_equals_the_dense_chain(m, n):
    args = inputs.slam(30 + m, 3, m, n, edge=True)
    upd = slam.build(*args, SIGMA)
    h, r, keep, gamma = _chain_slam(*args, SIGMA)
    _same(upd.jac, h)
    _same(upd.res, r)
    _same(upd.noise_std, torch.full_like(r, SIGMA))
    kept = (upd.jac.reshape(3, n, 2, -1) != 0).any(-1).any(-1)
    assert torch.equal(kept, keep)
    # the special rows, the inactive slot, the outlier, track length 0, the NaN P
    assert keep[0, 0] and not keep[:, 1:4].any() and not keep[1].any()


def _vmap(fn, *args):
    return jax.vmap(fn)(*(jnp.asarray(x.numpy()) for x in args))


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_window_builders_match_jax(m, n, k):
    obs, mask, q, p, cov = inputs.window(40 + m, 2, k, m, n)
    upd, info = msckf.build(obs, mask, q, p, cov, SIGMA, n)
    ref_upd, ref_info = _vmap(lambda o, ms, qq, pp, c: jmsckf.build(o, ms, qq, pp, c, SIGMA, n),
                              obs, mask, q, p, cov)
    np.testing.assert_array_equal(info.inlier.numpy(), np.asarray(ref_info.inlier))
    np.testing.assert_array_equal(info.valid.numpy(), np.asarray(ref_info.valid))
    assert info.inlier.sum() >= 2 * (k - 4)
    _close(upd.jac, ref_upd.jac)
    _close(upd.res, ref_upd.res)
    upd, init = msckf_slam.build(obs, mask, q, p, cov, SIGMA, n)
    ref_upd, ref_init = _vmap(
        lambda o, ms, qq, pp, c: jmsckf_slam.build(o, ms, qq, pp, c, SIGMA, n),
        obs, mask, q, p, cov)
    np.testing.assert_array_equal(init.inlier.numpy(), np.asarray(ref_init.inlier))
    for got, want in ((upd.jac, ref_upd.jac), (upd.res, ref_upd.res), (init.h1, ref_init.h1),
                      (init.h2, ref_init.h2)):
        _close(got, want)
    # r1 is the residual's part along the feature: ~0 at the triangulated
    # point, so it is held on the residuals' scale
    _close(init.r1, ref_init.r1, float(upd.res.abs().max()))


@pytest.mark.parametrize("m,n", [s[:2] for s in SHAPES])
def test_slam_builder_matches_jax(m, n):
    f, anc, q, p, z, act, ln, cov, cur = inputs.slam(50 + m, 2, m, n)
    upd = slam.build(f, anc, q, p, z, act, ln, cov, cur, SIGMA)
    ref = _vmap(lambda *x: jslam.build(*x, cur, SIGMA), f, anc, q, p, z, act, ln, cov)
    _close(upd.jac, ref.jac)
    _close(upd.res, ref.res)
    np.testing.assert_array_equal((upd.jac != 0).any(-1).numpy(),
                                  np.asarray((ref.jac != 0).any(-1)))


def test_reflections_are_householder_qt():
    """The card's wrapper finds the reflections with householder_qt's own
    operations: its hf and res equal householder_qt's bit for bit."""
    g = torch.Generator().manual_seed(0)
    hf = torch.randn(3, 15, 30, 3, generator=g, dtype=torch.float64)
    res = torch.randn(3, 15, 30, generator=g, dtype=torch.float64)
    h = torch.randn(3, 15, 30, 150, generator=g, dtype=torch.float64)
    hf[0, :, 20:] = res[0, :, 20:] = 0.0  # an unobserved tail
    hf[1, 3] = 0.0  # a track with no feature Jacobian: no reflection
    hf_t, res_t, v, beta = track_rows._reflections(hf, res)  # the CPU: the plain version
    ref = linalg.householder_qt(hf, h, res)
    assert torch.equal(hf_t, ref[0]) and torch.equal(res_t, ref[2])
    assert v.shape == (3, 3, 15, 30) and beta.shape == (3, 15, 3)
    assert torch.equal(beta[1, 3], torch.zeros(3, dtype=torch.float64))


def test_track_rows_roofline_counts_each_gate_and_p_block():
    """The benchmark's ``track_rows_roofline`` work count against hand
    counts at the flagship configuration (M = N = 15, D = 150, float32, 15
    stack slots and 15 new SLAM features an agent), and its share of a
    traced run's device time."""
    import json
    from pathlib import Path
    from types import SimpleNamespace

    from benchmark.metrics import track_rows_roofline as trr

    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "benchmark/configs/flagship-m15n15-vga.json").read_text())
    a, r, c, d = 2, 27, 90, 150
    gate = 2 * r * c * c + r * (r + 1) * c  # Hw P, then the symmetric half of (Hw P) Hw^T
    assert gate == 505_440
    (f_ms, b_ms), (f_in, b_in), (f_sl, b_sl) = trr.frame_work(config, a)
    assert f_ms == f_in == a * 15 * gate
    p_block = a * c * c * 4  # each agent's 6M x 6M pose block, read once
    assert b_ms == a * 15 * (1 + (r * d + r) * 4 + 2) + p_block
    assert b_in == a * 15 * (1 + 30 * 16 * 4 + 4 + (r * d + r + 3 * d + 12) * 4 + 2) + p_block
    assert f_sl == a * 15 * (2 * 2 * 15 * 15 + 2 * 3 * 15)
    assert b_sl == a * 15 * (1 + (2 * d + 2) * 4 + 1) + a * 51 * 51 * 4
    least_s = 2 * f_ms / 67e12 + max(f_sl / 67e12, b_sl / 3.35e12)
    assert least_s == pytest.approx(sum(max(f / 67e12, b / 3.35e12)
                                        for f, b in trr.frame_work(config, a)))
    # two filter steps traced, each launch 0.01 ms on the device
    trace = {"kernel_launches": {"track_rows": 6}, "kernel_ms": {"track_rows": [0.01] * 6}}
    run = SimpleNamespace(trace=trace, config=config, agents=a)
    assert trr.read(run) == pytest.approx(100.0 * 2 * least_s / 6e-5)
    # nothing to read: no trace, no launch, or the tracer dropped an event
    assert trr.read(SimpleNamespace(trace=None, config=config, agents=a)) is None
    for launches, ms in ((0, []), (6, [0.01] * 5)):
        trace = {"kernel_launches": {"track_rows": launches}, "kernel_ms": {"track_rows": ms}}
        assert trr.read(SimpleNamespace(trace=trace, config=config, agents=a)) is None
