"""Parity tests of the port's dataset-replay ATE report
(``x_multi_agent_torch/utils/ate_report.py``) against the reference's
``scripts/ate_report.py``.

One small thermal dataset (2 agents, 120x160, 2.5 s, agent 1 degraded) is
written once by the port and reused by the reference (the same ``gen_key``).
Both packages replay it solo and collaboratively (an exchange every 5
frames) in float64: the reference's ``VioParams`` is wrapped to float64 here
(its script looks the class up at call time) and so is the port's. The port
gets the reference's random draws through its seams: the tracker's RANSAC
indices (``torch_helpers.jax_frame_indices`` on the port's own tracker state
and corrected image), the photometric draws (``jax_photo_sampler``) and the
collaboration gates' (``jax_keyed_sampler``); after each frame its
photometric gains, held to the reference's to 1e-12, take the reference's
bits (``torch_helpers.snap_gains``: an ulp there flips FAST's rounding
ties).
Positions, NEES and the output floats are held to 1e-6; hits, fused matches,
re-inits, bytes, track and match counts exactly.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import (CPU, float64, port_params, recording, reference_script,
                           with_reference_draws)
from x_multi_agent_torch.parallel import collab as tcollab
from x_multi_agent_torch.utils import ate_report as tar
from x_multi_agent_torch.utils import tree
from x_multi_agent_torch.vio import vio as tvio
from x_multi_agent_tpu.parallel import collab as jcollab
from x_multi_agent_tpu.utils import scene as jscene
from x_multi_agent_tpu.vio import vio as jvio

REPO = Path(__file__).resolve().parents[1]
N_AGENTS, H, W, DURATION, DEGRADED, EVERY = 2, 120, 160, 2.5, 1, 5
TOL = 1e-6
FLOATS = ("ate", "ate_aligned", "final_err", "mean_nees", "max_nees")
INTS = ("rr_fused", "n_reinits", "n_hits", "bytes_rr", "bytes_full")


ar = reference_script("ate_report")


_build_agent = tar.build_agent
_jax_build_agent = ar.build_agent


def _args(*extra, n_agents=N_AGENTS, every=EVERY):
    return ["--vocab", "random", "--agents", str(n_agents), "--exchange-every", str(every), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' replays of the module's dataset (:func:`_replays`)."""
    yield from _replays(str(tmp_path_factory.mktemp("ate_dataset")), N_AGENTS, DURATION, EVERY)


def _replays(root, n_agents, duration, every):
    """Both packages' solo and collaborative replays of one dataset of
    ``n_agents`` at HxW for ``duration`` s (an exchange every ``every``
    frames), the reference first (its photometric states recorded per
    agent-frame); the port's collaborative pass checkpoints at frame 15.
    Yields the record with both packages' float64 ``VioParams`` and
    ``DATASET_ROOT`` = ``root`` in place."""
    ref_states, snapped = {}, []

    def jax_agent(meta, degraded, words, ccfg, uav_id, collab, overrides=None):
        return recording(_jax_build_agent(meta, degraded, words, ccfg, uav_id, collab, overrides),
                          ref_states.setdefault((collab, uav_id), {}))

    def port_agent(meta, degraded, words, ccfg, uav_id, collab, overrides=None, device=None,
                   seed=0):
        v = _build_agent(meta, degraded, words, ccfg, uav_id, collab, overrides, device=CPU,
                         seed=seed)
        return with_reference_draws(v, ref_states[(collab, uav_id)], snapped)

    mp = pytest.MonkeyPatch()
    try:
        for mod in (ar, tar):
            mp.setattr(mod, "DATASET_ROOT", root)
        mp.setattr(jvio, "VioParams", float64(jvio.VioParams))
        mp.setattr(tvio, "VioParams", float64(tvio.VioParams))
        mp.setattr(ar, "build_agent", jax_agent)
        mp.setattr(tar, "build_agent", port_agent)
        metas = tar.ensure_dataset(n_agents, duration, H, W, degraded_idx=DEGRADED, device=CPU)
        stamps = [os.path.getmtime(os.path.join(m["dir"], "meta.json")) for m in metas]
        # the reference renders its texture before it looks for a dataset;
        # reusing one, it never reads it
        with pytest.MonkeyPatch.context() as tex:
            tex.setattr(jscene, "make_texture", lambda *a, **k: None)
            j_metas = ar.ensure_dataset(n_agents, duration, H, W, degraded_idx=DEGRADED)
        reused = [os.path.getmtime(os.path.join(m["dir"], "meta.json")) for m in j_metas]
        out = {"metas": metas, "j_metas": j_metas, "reused": stamps == reused, "root": root,
               "snapped": snapped, "port_agent": port_agent}

        def traces(name):
            with np.load(os.path.join(root, name)) as z:
                return {k: z[k] for k in z.files}

        out["jax_solo"] = [ar.run_solo(j_metas[a], a, a == DEGRADED, force=True)
                           for a in range(n_agents)]
        out["jax_solo_trace"] = [traces(f"trace_solo_a{a}.npz") for a in range(n_agents)]
        out["port_solo"] = [tar.run_solo(metas[a], a, a == DEGRADED, force=True, device=CPU)
                            for a in range(n_agents)]
        out["port_solo_trace"] = [traces(f"trace_solo_a{a}.npz") for a in range(n_agents)]

        args = tar.parse_args(_args(n_agents=n_agents, every=every))
        ccfg = tar.collab_config(args)
        hcfg = tar.helper_config(args, ccfg)
        out["ccfg"] = (ccfg, hcfg)
        j_words = jnp.asarray(_jax_words())
        j_agents = [ar.build_agent(j_metas[a], a == DEGRADED, j_words,
                                   jcollab.CollabConfig(**(ccfg if a == DEGRADED else hcfg)._asdict()),
                                   a, collab=True)
                    for a in range(n_agents)]
        out["jax_collab"] = ar.replay(j_agents, j_metas, exchange=True, exchange_every=every,
                                      trace_path=os.path.join(root, "jax_collab.npz"))
        out["jax_collab_trace"] = traces("jax_collab.npz")
        out["words"] = tar.make_words("random", CPU)
        agents = [tar.build_agent(metas[a], a == DEGRADED, out["words"],
                                  ccfg if a == DEGRADED else hcfg, a, collab=True)
                  for a in range(n_agents)]
        out["ckpt"] = os.path.join(root, "collab.ckpt.npz")
        out["port_collab"] = tar.replay(agents, metas, exchange=True, exchange_every=every,
                                        trace_path=os.path.join(root, "port_collab.npz"),
                                        ckpt_path=out["ckpt"], ckpt_every=15)
        out["port_collab_trace"] = traces("port_collab.npz")
        out["port_agents"] = agents
        yield out
    finally:
        mp.undo()


def _jax_words():
    from x_multi_agent_tpu.place_recognition.vocabulary import train_kmajority

    rng = np.random.default_rng(0)
    return train_kmajority(rng.integers(0, 256, (512, 32)).astype(np.uint8), 32, 7).words


# ---------------------------------------------------------------------------
# (a) configuration
# ---------------------------------------------------------------------------


META = dict(duration=2.5, h=H, w=W, fx=0.8 * W, fy=0.8 * W, v0=[0.0, 0.9, 0.0],
            p0=[1.5, 0.0, 0.0], q0=[0.0, 0.0, 0.0, 1.0],
            gen_key=dict(duration=2.5, h=H, w=W))


def test_constants_match_reference():
    for name in ("THERMAL", "MOTION", "DEG_GYRO_FACTOR", "DEG_ACCEL_FACTOR",
                 "AGENT_SIGMA_IMG_PX"):
        assert getattr(tar, name) == getattr(ar, name), name
    assert tar.CODE_SALT != ar.CODE_SALT  # a reference solo cache never pairs with the port


@pytest.mark.parametrize("agent", range(5))
def test_filter_config_matches_reference(agent):
    """Per agent index (past the calibrated sigmas too), degraded or not,
    with and without overrides; the solo-cache keys differ by the salt."""
    for deg in (False, True):
        assert tar.filter_config(META, deg, agent) == ar.filter_config(META, deg, agent)
        over = dict(sigma_img_px=5.0, photometric=None)
        assert tar.filter_config(META, deg, agent, over) == ar.filter_config(META, deg, agent, over)
        assert tar.solo_cache_key(META, deg, agent) != ar.solo_cache_key(META, deg, agent)


def test_words_match_reference():
    np.testing.assert_array_equal(tar.make_words("random", CPU).numpy(), _jax_words())


@pytest.mark.parametrize("agent,collab", [(0, False), (1, True)])
def test_build_agent_matches_reference(agent, collab):
    """The facade each package builds: its ``VioParams`` (through
    ``port_params``), tracker parameters, camera, photometric
    configuration, health monitor and collaboration configuration."""
    args = tar.parse_args(_args())
    ccfg = tar.collab_config(args)
    words = tar.make_words("random", CPU)
    deg = agent == DEGRADED
    jv = ar.build_agent(META, deg, jnp.asarray(words.numpy()), jcollab.CollabConfig(**ccfg._asdict()),
                        agent, collab)
    tv = _build_agent(META, deg, words, ccfg, agent, collab, device=CPU)
    assert port_params(jv.params) == tv.params
    jt = jv._tracker_params._asdict()
    assert {k: jt.pop(k) for k in ("use_pallas", "use_pallas_fast")} == dict.fromkeys(
        ("use_pallas", "use_pallas_fast"))  # the reference's kernel switches, unset
    assert jt == tv._tracker_params._asdict()
    assert tuple(jv._camera) == tuple(tv._camera)
    assert jv._photo_dims == tuple(tv._photo_cfg.dims)
    assert jv._photo_eps == (tv._photo_cfg.epsilon_gap, tv._photo_cfg.epsilon_base)
    assert (jv._photo_spatial is None) == (tv.photo.spatial is None)
    assert jv._health == tv._health
    np.testing.assert_allclose(tv.tail_state().p[0].numpy(), np.asarray(jv.tail_state().p))
    if collab:
        assert jv._ccfg._asdict() == tv._ccfg._asdict()
        assert jv._uav_id == tv._uav_id
        np.testing.assert_array_equal(np.asarray(jv._words), tv._words.numpy())


class _Captured(Exception):
    pass


@pytest.mark.parametrize("argv", [
    [],
    ["--cooldown", "0", "--ci-slam-w", "0.05", "--match-budget", "4", "--no-store",
     "--no-stored-slam", "--no-stored-msckf", "--no-shortci"],
])
def test_collab_config_matches_reference_main(argv, monkeypatch):
    """The ``CollabConfig`` the reference's ``main`` builds from the flags
    (captured as it is constructed) is the port's, field by field."""
    import bench

    seen = {}

    def capture(**kwargs):
        seen.update(kwargs)
        raise _Captured

    monkeypatch.setattr(bench, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(ar, "ensure_dataset", lambda *a, **k: [])
    monkeypatch.setattr(jcollab, "CollabConfig", capture)
    monkeypatch.setattr(sys, "argv", ["ate_report.py", "--vocab", "random", *argv])
    with pytest.raises(_Captured):
        ar.main()
    monkeypatch.undo()
    args = tar.parse_args(["--vocab", "random", *argv])
    assert tar.collab_config(args)._asdict() == jcollab.CollabConfig(**seen)._asdict()
    helper = tar.helper_config(tar.parse_args(["--ci-slam-w-helper", "0.3", *argv]),
                               tar.collab_config(args))
    assert helper.ci_slam_w == 0.3 and helper._replace(ci_slam_w=args.ci_slam_w) == tar.collab_config(args)


# ---------------------------------------------------------------------------
# (b) both replays on one dataset
# ---------------------------------------------------------------------------


def _assert_out_close(got, ref, what):
    for k in FLOATS:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL, err_msg=f"{what}.{k}")
    for k in INTS:
        assert got[k] == ref[k], f"{what}.{k}: {got[k]} != {ref[k]}"


def _assert_trace_close(got, ref, what):
    """Positions and errors to 1e-6 m; NEES to 1e-6, relative above 1 (the
    first frames' NEES under the near-zero prior run to thousands)."""
    for k in ("est", "err"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL, err_msg=f"{what}.{k}")
    worst = np.max(np.abs(got["nees"] - ref["nees"]) / np.maximum(np.abs(ref["nees"]), 1.0))
    assert worst <= TOL, f"{what}.nees: {worst}"
    for k in ("n_tracks", "n_matches"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{what}.{k}")
    # the generator's ground truth against the one read back from gt.csv
    np.testing.assert_allclose(got["gt"], ref["gt"], rtol=0, atol=1e-9, err_msg=f"{what}.gt")


def test_dataset_reused_across_packages(runs):
    """The reference's ``ensure_dataset`` reuses the port's dataset (same
    ``gen_key``) and reads the same meta."""
    assert runs["reused"]
    for m, jm in zip(runs["metas"], runs["j_metas"]):
        for k in ("fx", "fy", "v0", "p0", "q0", "gen_key", "dir"):
            assert m[k] == jm[k], k
        np.testing.assert_allclose(m["cam_p"], jm["cam_p"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("agent", range(N_AGENTS))
def test_solo_replay_matches_reference(runs, agent):
    _assert_out_close(runs["port_solo"][agent], runs["jax_solo"][agent], f"solo{agent}")
    _assert_trace_close(runs["port_solo_trace"][agent], runs["jax_solo_trace"][agent],
                        f"solo{agent}")
    assert runs["port_solo"][agent]["n_reinits"] == [0]


def _assert_collab_matches(runs, n_agents, duration):
    """The collaborative passes frame by frame and in the output, with at
    least one hit and one fused match; the full broadcast's bytes from the
    payload's size."""
    got, ref = runs["port_collab"], runs["jax_collab"]
    _assert_out_close(got, ref, "collab")
    _assert_trace_close(runs["port_collab_trace"], runs["jax_collab_trace"], "collab")
    assert got["n_hits"] >= 1 and sum(got["rr_fused"]) >= 1, got
    n_after = int(duration * 10) - 11
    pb = tcollab.payload_nbytes(runs["port_agents"][0].get_data_to_send())
    assert got["bytes_full"] == pb * n_after * n_agents * (n_agents - 1)


def test_collab_replay_matches_reference(runs):
    _assert_collab_matches(runs, N_AGENTS, DURATION)


@pytest.mark.slow
def test_long_collab_replay_matches_reference(tmp_path):
    """The report's cadence over many receives (~8.5 min on one CPU
    worker): 4 agents for 12 s with an exchange every 10 frames, so each
    agent receives from 3 peers 9 times each, past the payload ring (4
    slots) and the re-fusion cooldown (10 receives)."""
    with contextlib.closing(_replays(str(tmp_path), 4, 12.0, 10)) as replays:
        runs = next(replays)
        _assert_collab_matches(runs, 4, 12.0)
        # 5 hits per ordered pair on average: past the payload ring
        assert runs["port_collab"]["n_hits"] >= 4 * 3 * 5, runs["port_collab"]


# ---------------------------------------------------------------------------
# (c) resume
# ---------------------------------------------------------------------------


def test_collab_resume_bit_for_bit(runs, monkeypatch):
    """Fresh facades resumed from the checkpoint the collaborative pass
    wrote at frame 15 (re-fusion cooldown on, so the recency tables are part
    of it) give the uninterrupted pass's output, trace and states bit for
    bit."""
    ccfg, hcfg = runs["ccfg"]
    assert ccfg.refuse_cooldown > 0 and os.path.exists(runs["ckpt"])
    restored = []
    restore = tar._restore_agent

    def keep(v, state):
        restore(v, state)
        restored.append(dict(v._fuse_recency))

    monkeypatch.setattr(tar, "_restore_agent", keep)
    metas = runs["metas"]
    agents = [runs["port_agent"](metas[a], a == DEGRADED, runs["words"],
                                 ccfg if a == DEGRADED else hcfg, a, collab=True)
              for a in range(N_AGENTS)]
    trace = os.path.join(runs["root"], "port_collab_resumed.npz")
    got = tar.replay(agents, metas, exchange=True, exchange_every=EVERY, trace_path=trace,
                     ckpt_path=runs["ckpt"], ckpt_every=15)
    assert len(restored) == N_AGENTS and any(restored), "no recency in the checkpoint"
    ref = runs["port_collab"]
    assert {k: v for k, v in got.items() if k != "wall_s"} == \
        {k: v for k, v in ref.items() if k != "wall_s"}
    with np.load(trace) as z:
        for k, x in runs["port_collab_trace"].items():
            np.testing.assert_array_equal(z[k], x, err_msg=k)
    for v, v_ref in zip(agents, runs["port_agents"]):
        a, b = tree.leaves(tar._agent_state(v, N_AGENTS)), tree.leaves(tar._agent_state(v_ref, N_AGENTS))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y)
            else:
                assert x == y or (x != x and y != y)


# ---------------------------------------------------------------------------
# (d) the reference-layout directory
# ---------------------------------------------------------------------------


def test_replay_dataset_dir_matches_reference(tmp_path, monkeypatch):
    from test_ref_ingest import _synthesize

    _synthesize(str(tmp_path))
    monkeypatch.setattr(jvio, "VioParams", float64(jvio.VioParams))
    monkeypatch.setattr(tvio, "VioParams", float64(tvio.VioParams))
    ref = ar.replay_dataset_dir(str(tmp_path))
    got = tar.replay_dataset_dir(str(tmp_path), device=CPU)
    assert got["applied"] == ref["applied"] and got["frames"] == ref["frames"]
    assert got["applied"] >= 0.9 * got["frames"]
    for k in ("ate", "final_err"):
        assert abs(got[k] - ref[k]) <= TOL, (k, got[k], ref[k])


# ---------------------------------------------------------------------------
# (e) no JAX; the card by default
# ---------------------------------------------------------------------------


def test_ate_report_never_imports_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['ate_report_torch.py', '--help']\n"
        "try:\n"
        "    runpy.run_path('scripts/ate_report_torch.py', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "from x_multi_agent_torch.utils import ate_report as ar\n"
        f"meta = {META!r}\n"
        "args = ar.parse_args(['--vocab', 'random'])\n"
        "w = ar.make_words('random', 'cpu')\n"
        "v = ar.build_agent(meta, True, w, ar.collab_config(args), 1, True, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('jax', 'x_multi_agent_tpu', 'bench')))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "--vocab" in out.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card error")
def test_ate_report_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tar.make_words("random")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _build_agent(META, False, None, None, 0, collab=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tar.replay_dataset_dir("unused")


# ---------------------------------------------------------------------------
# (f) on the card (``gpu``-marked, skipped here)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_report_on_the_card(tmp_path, monkeypatch):
    """The report as its CLI runs it with ``--vocab random --duration 3``
    (4 agents at 480x640, agent 1 degraded, rounds after frames 19 and 29),
    its dataset rendered on the card into ``tmp_path``: every position
    finite, no re-initialization solo or collaborative, every helper's
    collaborative aligned ATE under 1 m, the full broadcast a payload to
    each of the 12 ordered pairs on each frame after frame 10, the kernels
    launched (K1, K2 on each level of every agent-frame after the first,
    the track rows on every update); and every facade the report built,
    once dropped, freed with its graphs."""
    import gc
    import glob
    import json
    import weakref

    from x_multi_agent_torch.vio.updates import track_rows
    from x_multi_agent_torch.vision import fast, lk

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    built = []

    def tracked(*a, **kw):
        v = _build_agent(*a, **kw)
        built.append(weakref.ref(v))
        return v

    monkeypatch.setattr(tar, "DATASET_ROOT", str(tmp_path))
    monkeypatch.setattr(tar, "build_agent", tracked)
    args = tar.parse_args(["--vocab", "random", "--duration", "3"])
    kernels = (fast.K1, lk.K2, track_rows.TRACK_ROWS)
    before = [k.launches for k in kernels]
    rep, agents = tar.run_report(args, device="cuda")
    n_k1, n_k2, n_rows = (k.launches - n for k, n in zip(kernels, before))
    na, n_frames = args.agents, int(args.duration * 10)
    solo = [json.load(open(f)) for f in sorted(glob.glob(str(tmp_path / "solo_a*.json")))]
    traces = [f"trace_solo_a{a}.npz" for a in range(na)] + ["trace_collab.npz"]
    assert all(np.isfinite(np.load(tmp_path / f)["est"]).all() for f in traces)
    assert len(solo) == na and not any(s["n_reinits"][0] for s in solo)
    assert not any(rep["per_agent"]["n_reinits"])
    assert rep["gates"]["helpers_converged_collab"], rep["per_agent"]["ate_collab_m"]
    payload = tcollab.payload_nbytes(agents[0].get_data_to_send())
    assert rep["request_comm"]["bytes_full_broadcast"] == payload * na * (na - 1) * (n_frames - 11)
    assert n_k1 >= 2 * na and n_k2 >= 3 * 2 * na * (n_frames - 1) and n_rows >= 3 * 2 * na
    del rep, agents
    gc.collect()
    assert len(built) == 2 * na and not [r for r in built if r() is not None]
