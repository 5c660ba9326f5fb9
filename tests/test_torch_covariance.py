"""PyTorch port: the Kalman update's covariance (ROADMAP C20).

The port updates the covariance in Joseph form, P <- (I - K H) P (I - K H)^T
+ K K^T, where the reference computes (I - K H) P: the two agree in exact
arithmetic. In float32 the image benchmark's fleet, started at rest, loses
agents under the reference's form: their covariance leaves the PSD cone,
S stops factorizing and the covariance turns non-finite (64 agents on the
23-frame orbit data: agent 44, at frame 10). An agent whose S does not
factorize gets no update, so its covariance stays finite. These tests hold:

* the update against the reference's ``ops.linalg.kalman_update`` in
  float64, to 1e-9 of each output's largest entry;
* an agent whose S does not factorize: no correction beyond undoing the
  earlier iterations', its covariance kept, every output finite, the other
  agents updated as alone;
* ``spd_solve``: NaN where the factorization fails, so that a gate rejects;
* agent 44's recorded filter inputs (``tests/data/at_rest_agent44.npz``)
  through the port in float32 and float64: finite after every frame, and
  PSD to rounding in float64 (run as a script, this file prints the replay
  through the reference as well);
* on a card (``gpu``-marked, skipped here): the fleet, eagerly, keeps every
  covariance finite over 20 frames at 64 agents on the 23-frame data; at
  512 agents on five datasets it loses none, and leaves fewer indefinite
  than the reference's form on the port's solve (run with ``-s``, the test
  prints both counts).
"""
import gc
import os

import numpy as np
import pytest
import torch

from x_multi_agent_torch.ops import linalg

F64 = torch.float64
# agent 44's filter inputs, frames 0-19, as the tracker gave them on an H100
# for the at-rest 64-agent fleet on the 23-frame 480x640 orbit data
# (``Matches`` fields but ``desc`` as ``m_*``; the IMU window as ``imu_*``)
RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "at_rest_agent44.npz")
MATCH_FIELDS = ("track_id", "prev_pt", "cur_pt", "valid", "desc_valid", "tile", "level")
IMU_FIELDS = ("times", "seqs", "w", "a", "meas_time")


def replay(impl: str, dtype: str) -> list:
    """The recorded inputs through the port's or the reference's
    (``impl``) filter step at A = 1 in ``dtype``, from the fleet's start at
    rest: the covariance after each frame (float64 numpy)."""
    rec = np.load(RECORDED)
    np_dt = np.float64 if dtype == "float64" else np.float32

    def frame(k, prefix, names):
        return [rec[prefix + n][k].astype(np_dt) if rec[prefix + n].dtype.kind == "f"
                else rec[prefix + n][k] for n in names]

    desc = np.zeros((1, rec["m_valid"].shape[1], 32), np.uint8)
    covs = []
    if impl == "port":
        from x_multi_agent_torch import configs
        from x_multi_agent_torch.parallel import mesh
        from x_multi_agent_torch.vio import pipeline, vio
        from x_multi_agent_torch.vio import track_manager as tm

        params = configs.flagship_params()._replace(dtype=dtype)
        fs, slots = vio.init_at_time(params, 0.0, 1, "cpu")
        step = mesh.agent_step(params)
        for k in range(rec["m_valid"].shape[0]):
            m = dict(zip(MATCH_FIELDS, (torch.from_numpy(x)[None]
                                        for x in frame(k, "m_", MATCH_FIELDS))))
            meas = pipeline.FrameMeasurement.from_matches(
                params.cfg, tm.Matches(desc=torch.from_numpy(desc), **m))
            imu = [torch.from_numpy(np.asarray(x))[None] for x in frame(k, "imu_", IMU_FIELDS)]
            fs, slots, _ = step(fs, slots, *imu, meas)
            covs.append(fs.cov[0].double().numpy())
        return covs
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from x_multi_agent_tpu.parallel import mesh as jmesh
    from x_multi_agent_tpu.vio import pipeline as jpipe
    from x_multi_agent_tpu.vio import track_manager as jtm
    from x_multi_agent_tpu.vio import vio as jvio

    params = ge._params()._replace(dtype=dtype)
    fs, slots = jax.tree.map(lambda x: x[None], jvio.init_at_time(params, 0.0))
    step = jax.jit(jmesh.agent_step_fn(params))
    to_meas = jax.vmap(lambda m: jpipe.FrameMeasurement.from_matches(params.cfg, m))
    for k in range(rec["m_valid"].shape[0]):
        m = dict(zip(MATCH_FIELDS, (jnp.asarray(x)[None] for x in frame(k, "m_", MATCH_FIELDS))))
        imu = [jnp.asarray(x)[None] for x in frame(k, "imu_", IMU_FIELDS)]
        fs, slots, _ = step(fs, slots, *imu, to_meas(jtm.Matches(desc=jnp.asarray(desc), **m)))
        covs.append(np.asarray(fs.cov[0], np.float64))
    return covs


def _eig_ratio(cov: np.ndarray) -> float:
    e = np.linalg.eigvalsh(0.5 * (cov + cov.T))
    return e[0] / e[-1]


def _spd(rng, a, d, lo=-3.0, hi=2.0):
    q, _ = np.linalg.qr(rng.standard_normal((a, d, d)))
    lam = 10.0 ** rng.uniform(lo, hi, (a, d))
    p = (q * lam[:, None, :]) @ q.transpose(0, 2, 1)
    return 0.5 * (p + p.transpose(0, 2, 1))


@pytest.mark.parametrize("d,r", [(15, 4), (21, 21), (9, 30)])
def test_kalman_update_matches_the_reference_in_float64(d, r):
    import jax
    import jax.numpy as jnp

    from x_multi_agent_tpu.ops import linalg as jlinalg

    rng = np.random.default_rng(d * 100 + r)
    a = 8
    cov = _spd(rng, a, d)
    h = rng.standard_normal((a, r, d)) * 10.0
    res = rng.standard_normal((a, r))
    corr = rng.standard_normal((a, d)) * 1e-2
    ref = jax.vmap(jlinalg.kalman_update)(*(jnp.asarray(x) for x in (cov, h, res, corr)))
    got = linalg.kalman_update(*(torch.from_numpy(x) for x in (cov, h, res, corr)))
    for g, r_ in zip(got, ref):
        r_ = np.asarray(r_)
        np.testing.assert_allclose(g.numpy(), r_, rtol=0, atol=1e-9 * np.abs(r_).max())


def test_agent_whose_innovation_does_not_factorize_gets_no_update():
    rng = np.random.default_rng(3)
    d, r = 6, 3
    good = _spd(rng, 1, d)[0]
    bad = np.diag([-5.0, 1.0, 1.0, 1.0, 1.0, 1.0])  # lost its definiteness
    cov = torch.from_numpy(np.stack([good, bad]))
    h = torch.from_numpy(rng.standard_normal((2, r, d)))
    h[1] = 0.0
    h[1, 0, 0] = 1.0  # S[0, 0] = -5 + 1 < 0: no Cholesky factor
    res = torch.from_numpy(rng.standard_normal((2, r)))
    corr = torch.from_numpy(rng.standard_normal((2, d)))
    c, p = linalg.kalman_update(cov, h, res, corr)
    assert bool(torch.isfinite(c).all()) and bool(torch.isfinite(p).all())
    assert torch.equal(c[1], -corr[1]) and torch.equal(p[1], cov[1])
    c0, p0 = linalg.kalman_update(cov[:1], h[:1], res[:1], corr[:1])
    assert torch.equal(c[0], c0[0]) and torch.equal(p[0], p0[0])


def test_spd_solve_is_nan_where_the_factorization_fails():
    s = torch.stack([torch.eye(3, dtype=F64) * 2.0, torch.diag(torch.tensor([1.0, -1.0, 1.0],
                                                                              dtype=F64))])
    b = torch.ones(2, 3, 1, dtype=F64)
    x = linalg.spd_solve(s, b)
    torch.testing.assert_close(x[0], torch.full((3, 1), 0.5, dtype=F64), rtol=0, atol=1e-15)
    assert bool(torch.isnan(x[1]).all())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_recorded_at_rest_agent_keeps_a_finite_covariance(dtype):
    """Agent 44's recorded inputs through the port's filter step on the CPU:
    after every frame its covariance is finite, and in float64 its smallest
    eigenvalue is at least -1e-9 of its largest. In float32 the port does
    not keep it PSD (ROADMAP C20): with six CPU threads the replay stays
    above -2.4e-7, with one it reaches -3.3e-3. ``PYTHONPATH=.
    python tests/test_torch_covariance.py`` prints the replay through the
    reference too, which in float32 turns non-finite at frame 11."""
    covs = replay("port", dtype)
    assert len(covs) == 20 and all(np.isfinite(c).all() for c in covs)
    if dtype == "float64":
        worst = min(_eig_ratio(c) for c in covs)
        assert worst >= -1e-9, worst


def _reference_form_update(cov, h, res, correction_total):
    """The reference's update, P <- sym((I - K H) P), on the port's solve
    (the output where S does not factorize left as the solve gives it)."""
    pht = cov @ h.transpose(-1, -2)
    s = h @ pht + torch.eye(h.shape[-2], dtype=cov.dtype, device=cov.device)
    k = linalg.spd_solve_ex(s, pht.transpose(-1, -2))[0].transpose(-1, -2)
    inn = res + (h @ correction_total[..., None])[..., 0]
    correction = (k @ inn[..., None])[..., 0] - correction_total
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return correction, linalg.symmetrize((eye - k @ h) @ cov)


def _at_rest_fleet(agents: int, n_data: int, n_frames: int = 20):
    """The image benchmark's fleet (``utils/bench.py:bench_image``: every
    agent at rest at the origin, the flagship filter and tracker) on the
    ``n_data``-frame 480x640 orbit data, ``n_frames`` eager frames on the
    card: (agents whose covariance was not finite after some frame, agents
    whose smallest eigenvalue fell below -1e-4 of their largest or that
    were not finite)."""
    from x_multi_agent_torch import configs
    from x_multi_agent_torch.utils import bench
    from x_multi_agent_torch.vio import vio
    from x_multi_agent_torch.vio.frame_step import frame_step
    from x_multi_agent_torch.vision import tracker

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    h, w = 480, 640
    params = configs.flagship_params()
    tparams = configs.flagship_tracker(params.cfg.tracks.n_matches)
    cam = configs.flagship_camera(h, w)
    gc.collect()  # programs of earlier tests in reference cycles hold memory until collected
    torch.cuda.empty_cache()  # the rendered data is one block (17 GB at 512 agents x 27)
    frames, imu = bench.orbit_frames(agents, n_data, h, w, dev)
    imu = [x.to(params.tdtype) if x.is_floating_point() else x for x in imu]
    fs, slots = vio.init_at_time(params, 0.0, agents, dev)
    ts = tracker.TrackerState.zero(tparams, agents, h, w, device=dev)
    lost = torch.zeros(agents, dtype=torch.bool, device=dev)
    indefinite = torch.zeros_like(lost)
    for k in range(n_frames):
        ts, fs, slots, _, _ = frame_step(params, tparams, cam, ts, fs, slots, frames[k],
                                         *(x[k] for x in imu))
        finite = torch.isfinite(fs.cov).flatten(1).all(1)
        eye = torch.eye(fs.cov.shape[-1], dtype=fs.cov.dtype, device=dev)
        eig = torch.linalg.eigvalsh(torch.where(finite[:, None, None], fs.cov, eye).double())
        lost |= ~finite
        indefinite |= ~finite | (eig[:, 0] < -1e-4 * eig[:, -1])
    del frames, imu, fs, slots, ts
    torch.cuda.empty_cache()
    return lost.nonzero().flatten().tolist(), indefinite.nonzero().flatten().tolist()


@pytest.mark.gpu
def test_at_rest_image_fleet_keeps_every_covariance_finite():
    """The fleet of 64 agents on the 23-frame data, where the reference's
    form lost agent 44 at frame 10: no agent lost in 20 frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lost, _ = _at_rest_fleet(64, 23)
    assert not lost, f"the covariance of agents {lost} turned non-finite"


@pytest.mark.gpu
def test_at_rest_fleets_lose_no_agent_where_the_reference_form_does(monkeypatch):
    """512 agents on the 21- to 30-frame data, 20 frames each, with the
    port's update and with the reference's form: the port loses no agent
    and leaves fewer indefinite (both counts printed per dataset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    total = {"port": [0, 0], "reference form": [0, 0]}
    for n_data in (21, 23, 25, 27, 30):
        got = {"port": _at_rest_fleet(512, n_data)}
        with monkeypatch.context() as m:
            m.setattr(linalg, "kalman_update", _reference_form_update)
            got["reference form"] = _at_rest_fleet(512, n_data)
        for name, (lost, indefinite) in got.items():
            total[name][0] += len(lost)
            total[name][1] += len(indefinite)
            print(f"512 agents at rest, {n_data}-frame data, {name}: lost {lost}, indefinite "
                  f"{indefinite}")
    print(f"lost, indefinite in all: {total}")
    assert total["port"][0] == 0 and total["port"][1] < total["reference form"][1], total

if __name__ == "__main__":
    # the recorded agent through the port and the reference, float32 and
    # float64: per frame the smallest / largest eigenvalue of its covariance
    import subprocess
    import sys

    if len(sys.argv) == 3:
        if sys.argv[2] == "float64":
            import jax

            jax.config.update("jax_enable_x64", True)
        covs = replay(sys.argv[1], sys.argv[2])
        print(f"{sys.argv[1]} {sys.argv[2]}: " + " ".join(
            f"{k}:{_eig_ratio(c):.3g}" if np.isfinite(c).all() else f"{k}:nan"
            for k, c in enumerate(covs)), flush=True)
    else:
        for impl in ("reference", "port"):
            for dtype in ("float32", "float64"):  # one process each: JAX's x64 is global
                subprocess.run([sys.executable, __file__, impl, dtype], check=True)
