"""Parity tests of the port's ATE-report studies (``x_multi_agent_torch/
utils/{harsh_recovery,diag_solo,photometric_ablation,debug_collab_gates}
.py``) against the reference's scripts of the same names.

The port writes each study's small dataset once (120x160, 3.5 s) and the
reference reuses it (the same ``gen_key``). Both packages run in float64
(each package's ``VioParams`` wrapped to float64; the scripts look the class
up at call time), the port with the reference's random draws
(``torch_helpers.with_reference_draws``: the tracker's RANSAC indices, the
photometric and collaboration draws, the reference's gain bits once they
agree to 1e-12). Positions, NEES and the output floats are held to 1e-6;
re-inits, the health monitor's counters after every frame and the gate
bisect's counts exactly.
"""
import contextlib
import inspect
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_helpers import (CPU, REPO, float64, port_params, recording, reference_script,
                           with_reference_draws)
from x_multi_agent_torch.utils import ate_report as tar
from x_multi_agent_torch.utils import debug_collab_gates as tg
from x_multi_agent_torch.utils import diag_solo as td
from x_multi_agent_torch.utils import harsh_recovery as th
from x_multi_agent_torch.utils import photometric_ablation as tp
from x_multi_agent_torch.utils import scene as tscene
from x_multi_agent_torch.vio import vio as tvio
from x_multi_agent_tpu.parallel import collab as jcollab
from x_multi_agent_tpu.place_recognition import vocabulary as jvocab
from x_multi_agent_tpu.utils import scene as jscene
from x_multi_agent_tpu.vio import vio as jvio

ar = reference_script("ate_report")
rh = reference_script("harsh_recovery")
rp = reference_script("photometric_ablation")
rd = reference_script("diag_solo")
rg = reference_script("debug_collab_gates")

H, W, DURATION = 120, 160, 3.0
N_FRAMES = int(DURATION * 10)
OUTAGE, BAD_FRAMES = (6, 24), 15  # the monitor's starved-frame gate fires at frame 20
GATE_FRAMES = 25
TOL = 1e-6
# the health monitor's counters, read after every frame
COUNTERS = ("_bad_frames", "_grace", "_reinit_streak", "_healthy_frames", "n_reinits")


class _Captured(Exception):
    pass


def _jax_words():
    from x_multi_agent_tpu.place_recognition.vocabulary import train_kmajority

    rng = np.random.default_rng(0)
    return train_kmajority(rng.integers(0, 256, (512, 32)).astype(np.uint8), 32, 7).words


def _counting(v, log):
    """``v``'s health-monitor counters after each frame, into ``log``."""
    inner = v.process_image_measurement

    def process_image_measurement(*args, **kwargs):
        applied = inner(*args, **kwargs)
        log.append(tuple(int(getattr(v, k, 0)) for k in COUNTERS))
        return applied

    v.process_image_measurement = process_image_measurement
    return v


class _Runs:
    """Both packages' ``build_agent`` and ``replay`` wrapped for a parity
    run: the reference's facades record their photometric state and
    counters per frame; the port's draw the reference's draws (the states
    of the reference's facade of the same call number) and record their
    counters; every replay writes a trace and keeps its raw output."""

    def __init__(self, mp, root):
        self.root = root
        self.ref_states, self.snapped = [], []
        self.counters = {"jax": [], "port": []}
        self.outs = {"jax": [], "port": []}
        build_j, build_t = ar.build_agent, tar.build_agent
        replay_j, replay_t = ar.replay, tar.replay

        def jax_agent(*args, **kwargs):
            self.ref_states.append({})
            self.counters["jax"].append([])
            v = recording(build_j(*args, **kwargs), self.ref_states[-1])
            return _counting(v, self.counters["jax"][-1])

        def port_agent(*args, **kwargs):
            kwargs["device"] = CPU
            k = len(self.counters["port"])
            self.counters["port"].append([])
            v = with_reference_draws(build_t(*args, **kwargs), self.ref_states[k], self.snapped)
            return _counting(v, self.counters["port"][-1])

        def replaying(inner, who):
            def replay(*args, **kwargs):
                n = len(self.outs[who])
                kwargs["trace_path"] = os.path.join(root, f"{who}_{n}.npz")
                out = inner(*args, **kwargs)
                with np.load(kwargs["trace_path"]) as z:
                    self.outs[who].append((out, {k: z[k] for k in z.files}))
                return out

            return replay

        mp.setattr(ar, "build_agent", jax_agent)
        mp.setattr(tar, "build_agent", port_agent)
        mp.setattr(ar, "replay", replaying(replay_j, "jax"))
        mp.setattr(tar, "replay", replaying(replay_t, "port"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Both packages' ``DATASET_ROOT`` in one temporary directory, their
    ``VioParams`` in float64, and the port's datasets written there: the
    harsh preset with the cheap IMU (agent 0), the vignette-0.30 variant,
    the thermal-free variant, and the ATE report's 3-agent dataset (agent
    1 degraded). The reference renders its texture before it looks for a
    dataset; reusing one, it never reads it."""
    root = str(tmp_path_factory.mktemp("studies"))
    mp = pytest.MonkeyPatch()
    try:
        for mod in (ar, tar):
            mp.setattr(mod, "DATASET_ROOT", root)
        mp.setattr(jvio, "VioParams", float64(jvio.VioParams))
        mp.setattr(tvio, "VioParams", float64(tvio.VioParams))
        mp.setattr(jscene, "make_texture", lambda *a, **k: None)
        import bench

        mp.setattr(bench, "_enable_compile_cache", lambda: None)
        out = dict(root=root)
        out["harsh"] = th.ensure_harsh_dataset(0, DURATION, "harsh", cheap_imu=True, h=H, w=W,
                                               device=CPU)
        out["vign"] = tp.ensure_vignette_dataset(DURATION, 0.30, 0.004, H, W, CPU)
        out["clean"] = td.dataset(td.parse_args(["--clean-thermal", "--duration", str(DURATION)]),
                                  H, W, CPU)
        out["metas"] = tar.ensure_dataset(3, DURATION, H, W, degraded_idx=1, device=CPU)
        out["stamps"] = {m["dir"]: os.path.getmtime(os.path.join(m["dir"], "meta.json"))
                         for m in [out["harsh"], out["vign"], out["clean"], *out["metas"]]}
        yield out
    finally:
        mp.undo()


def _small_ensure_dataset(orig):
    """A reference ``ensure_dataset`` at the module's size and duration (its
    scripts ask for 480x640, the gate bisect for 60 s)."""
    def ensure_dataset(n_agents, duration, h, w, degraded_idx=-1):
        return orig(n_agents, DURATION, H, W, degraded_idx=degraded_idx)

    return ensure_dataset


def _reference_main(mod, argv, mp):
    """Run a reference script's ``main`` with ``argv``; its standard output."""
    mp.setattr(sys, "argv", [mod.__name__ + ".py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def _assert_replay_close(got, ref, what):
    """Raw ``replay`` outputs and traces: positions, errors, ATE and NEES
    to 1e-6 (NEES relative above 1); re-inits, tracks and matches exactly."""
    (g, gt), (r, rt) = got, ref
    for k in ("ate", "ate_aligned", "final_err", "mean_nees", "max_nees"):
        np.testing.assert_allclose(g[k], r[k], rtol=0, atol=TOL, err_msg=f"{what}.{k}")
    assert g["n_reinits"] == r["n_reinits"], what
    for k in ("est", "err"):
        np.testing.assert_allclose(gt[k], rt[k], rtol=0, atol=TOL, err_msg=f"{what}.{k}")
    worst = np.nanmax(np.abs(gt["nees"] - rt["nees"]) / np.maximum(np.abs(rt["nees"]), 1.0))
    assert worst <= TOL, f"{what}.nees: {worst}"
    for k in ("n_tracks", "n_matches"):
        np.testing.assert_array_equal(gt[k], rt[k], err_msg=f"{what}.{k}")


# ---------------------------------------------------------------------------
# (a) the studies' settings
# ---------------------------------------------------------------------------


def test_presets_match_reference():
    assert th.PRESETS == rh.PRESETS
    assert th.SIGMA_IMG_PX == 14.0


def test_gate_variants_match_reference(gates):
    """The ``CollabConfig`` of every variant the reference's bisect fuses
    with (payload, then the served keyframe) is the port's."""
    ccfg = tg.collab_config()
    want = [ccfg._replace(**over)._asdict() for over in tg.VARIANTS.values()]
    got = [cc._asdict() for cc in gates["jax_ccfgs"]]
    assert got == want
    assert list(gates["port"]["variants"]) == list(gates["jax"]["variants"])


# ---------------------------------------------------------------------------
# (b) the variant datasets
# ---------------------------------------------------------------------------


def _fake_generator(calls, signature):
    """A stand-in for ``generate_agent_dataset_6dof`` that records its bound
    arguments (defaults applied) and writes only ``gt.csv``."""
    def generate(out_dir, seed, **kwargs):
        args = signature.bind(out_dir, seed, **kwargs)
        args.apply_defaults()
        calls.append(dict(args.arguments))
        os.makedirs(out_dir, exist_ok=True)
        cam_t = np.arange(4) / 10.0
        cam_p = np.arange(12.0).reshape(4, 3) + seed
        np.savetxt(os.path.join(out_dir, "gt.csv"), np.c_[cam_t, cam_p, np.zeros((4, 4))],
                   delimiter=",", header="t,p,q")
        return dict(fx=0.8 * args.arguments["w"], fy=0.8 * args.arguments["w"],
                    v0=np.array([0.0, 0.9, 0.01 * seed]), p0=np.array([1.5, 0.0, 0.0]),
                    q0=np.array([0.0, 0.0, 0.0, 1.0]), cam_t=cam_t, cam_p=cam_p)

    return generate


def _reference_variant(kind, monkeypatch, agent=1):
    """The reference's dataset of ``kind`` for ``agent`` (the ablation's is
    agent 0's): its directory."""
    if kind == "harsh":
        return rh.ensure_harsh_dataset(agent, DURATION, "harsh", cheap_imu=True)["dir"]
    seen = {}

    def capture(meta, *args, **kwargs):
        seen["dir"] = meta["dir"]
        raise _Captured

    monkeypatch.setattr(ar, "build_agent", capture)
    argv = dict(vign=["--duration", str(DURATION), "--modes", "off"],
                clean=["--clean-thermal", "--agent", str(agent), "--duration", str(DURATION)])[kind]
    with pytest.raises(_Captured):
        _reference_main(dict(vign=rp, clean=rd)[kind], argv, monkeypatch)
    return seen["dir"]


def _port_variant(kind, agent=1):
    """The port's dataset of ``kind`` for ``agent`` at full size: its meta."""
    if kind == "harsh":
        return th.ensure_harsh_dataset(agent, DURATION, "harsh", cheap_imu=True, device=CPU)
    if kind == "vign":
        return tp.ensure_vignette_dataset(DURATION, 0.30, 0.004, device=CPU)
    args = td.parse_args(["--clean-thermal", "--agent", str(agent), "--duration", str(DURATION)])
    return td.dataset(args, device=CPU)


@pytest.mark.parametrize("kind", ["harsh", "vign", "clean"])
def test_variant_dataset_matches_reference(kind, tmp_path, monkeypatch):
    """At the reference's full size, with both generators stubbed: the
    directory, the generator's arguments (the texture and the port's device
    aside) and ``meta.json`` are the reference's."""
    ref_calls, port_calls = [], []
    monkeypatch.setattr(jscene, "make_texture", lambda *a, **k: None)
    monkeypatch.setattr(tscene, "make_texture", lambda *a, **k: None)
    monkeypatch.setattr(jscene, "generate_agent_dataset_6dof", _fake_generator(
        ref_calls, inspect.signature(jscene.generate_agent_dataset_6dof)))
    monkeypatch.setattr(tscene, "generate_agent_dataset_6dof", _fake_generator(
        port_calls, inspect.signature(tscene.generate_agent_dataset_6dof)))
    import bench

    monkeypatch.setattr(bench, "_enable_compile_cache", lambda: None)
    dirs, metas = {}, {}
    for who, write in (("jax", lambda: _reference_variant(kind, monkeypatch)),
                       ("port", lambda: _port_variant(kind)["dir"])):
        root = tmp_path / who
        monkeypatch.setattr(ar, "DATASET_ROOT", str(root))
        monkeypatch.setattr(tar, "DATASET_ROOT", str(root))
        dirs[who] = os.path.relpath(write(), root)
        with open(root / dirs[who] / "meta.json") as f:
            metas[who] = json.load(f)
    assert dirs["port"] == dirs["jax"]
    assert len(ref_calls) == len(port_calls) == 1
    skip = ("tex", "device", "chunk", "out_dir")
    assert {k: x for k, x in port_calls[0].items() if k not in skip} == \
        {k: x for k, x in ref_calls[0].items() if k not in skip}
    assert metas["port"] == metas["jax"]


@pytest.mark.parametrize("kind", ["harsh", "vign", "clean"])
def test_reference_reuses_the_ports_dataset(env, kind, monkeypatch):
    """The reference's dataset of ``kind`` is the one the port wrote at
    120x160: nothing is rendered and ``meta.json`` is untouched."""
    def no_render(*args, **kwargs):
        raise AssertionError("the reference rendered a dataset the port wrote")

    monkeypatch.setattr(jscene, "generate_agent_dataset_6dof", no_render)
    adir = env[kind]["dir"]
    assert _reference_variant(kind, monkeypatch, agent=0) == adir
    assert os.path.getmtime(os.path.join(adir, "meta.json")) == env["stamps"][adir]
    if kind == "harsh":
        meta = rh.ensure_harsh_dataset(0, DURATION, "harsh", cheap_imu=True)
        assert {k: x for k, x in meta.items() if k not in ("cam_t", "cam_p")} == \
            {k: x for k, x in env[kind].items() if k not in ("cam_t", "cam_p")}
        np.testing.assert_array_equal(meta["cam_p"], env[kind]["cam_p"])


# ---------------------------------------------------------------------------
# (c) harsh recovery: the health monitor's re-init inside a replay
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def harsh(env):
    """``run`` of both packages on the harsh dataset with the cheap IMU and
    the camera black over ``OUTAGE``, the monitor off and then on."""
    with pytest.MonkeyPatch.context() as mp:
        runs = _Runs(mp, env["root"])
        meta = rh.ensure_harsh_dataset(0, DURATION, "harsh", cheap_imu=True)
        out = {"jax": [], "port": [], "runs": runs}
        for health in (False, True):
            out["jax"].append(rh.run(meta, 0, health, N_FRAMES, cheap_imu=True, outage=OUTAGE))
            out["port"].append(th.run(env["harsh"], 0, health, N_FRAMES, cheap_imu=True,
                                      outage=OUTAGE, device=CPU))
    return out


def _assert_rounded_close(got: dict, ref: dict, what: str, digits: dict):
    """Outputs rounded to ``digits`` places: equal keys, integers and flags
    exactly, floats within one unit of their last place."""
    assert got.keys() == ref.keys(), what
    for k, r in ref.items():
        if k in digits:
            assert abs(got[k] - r) <= 1.01 * 10.0 ** -digits[k], (what, k, got[k], r)
        else:
            assert got[k] == r, (what, k, got[k], r)


@pytest.mark.parametrize("health", [False, True], ids=["monitor_off", "monitor_on"])
def test_harsh_run_matches_reference(harsh, health):
    """Per frame: positions, errors and NEES to 1e-6, the monitor's
    counters exactly; the re-inits exactly (none without the monitor, at
    least one with it: the starved-frame gate inside the blackout)."""
    i = int(health)
    runs = harsh["runs"]
    _assert_replay_close(runs.outs["port"][i], runs.outs["jax"][i], f"harsh health={health}")
    assert runs.counters["port"][i] == runs.counters["jax"][i]
    assert len(runs.counters["port"][i]) == N_FRAMES
    _assert_rounded_close(harsh["port"][i], harsh["jax"][i], "harsh",
                          dict(ate=3, ate_aligned=3, final_err=3, mean_nees=2))
    n = harsh["port"][i]["n_reinits"]
    assert (n > 0) if health else (n == 0), harsh["port"][i]
    if health:  # the re-init opened a grace window on the frame the gate fired
        fired = [f for f, c in enumerate(runs.counters["port"][i]) if c[-1] > 0][0]
        assert OUTAGE[0] + BAD_FRAMES - 1 <= fired < OUTAGE[1]
        assert runs.counters["port"][i][fired][1] == 2 * BAD_FRAMES


def test_harsh_main_matches_reference(env, tmp_path, monkeypatch):
    """The CLI's report (settings, results and gates) for a short run of
    both passes, through both packages."""
    runs = _Runs(monkeypatch, str(tmp_path))
    argv = ["--presets", "harsh", "--cheap-imu", "--duration", str(DURATION), "--frames", "5",
            "--outage", "2:4"]
    _reference_main(rh, argv + ["--out", str(tmp_path / "jax.json")], monkeypatch)
    port = th.main(argv + ["--out", str(tmp_path / "port.json")], h=H, w=W, device=CPU)
    with open(tmp_path / "jax.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == port
    assert port["settings"] == ref["settings"] and port["gates"] == ref["gates"]
    for key, res in ref["results"]["harsh"].items():
        _assert_rounded_close(port["results"]["harsh"][key], res, key,
                              dict(ate=3, ate_aligned=3, final_err=3, mean_nees=2))
    for i in range(2):
        _assert_replay_close(runs.outs["port"][i], runs.outs["jax"][i], f"main pass {i}")


# ---------------------------------------------------------------------------
# (d) solo stage diagnostics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["--no-oc", "--no-spatial"],
    ["--no-photo", "--no-health", "--sigma-img-px", "5", "--imu-scale", "3", "--agent", "2"],
    ["--no-photo", "--no-spatial", "--no-oc", "--degraded", "--agent", "1"],
])
def test_diag_overrides_match_reference_main(argv, monkeypatch):
    """The overrides (and the agent and its degraded flag) the reference's
    ``main`` passes to ``build_agent`` are ``overrides_from_args``'s."""
    import bench

    seen = {}

    def capture(meta, degraded, words, ccfg, uav_id, collab, overrides=None):
        seen.update(degraded=degraded, uav_id=uav_id, collab=collab, overrides=overrides)
        raise _Captured

    monkeypatch.setattr(bench, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(ar, "ensure_dataset", lambda n, *a, **k: [{}] * n)
    monkeypatch.setattr(ar, "build_agent", capture)
    with pytest.raises(_Captured):
        _reference_main(rd, argv, monkeypatch)
    args = td.parse_args(argv)
    assert td.overrides_from_args(args) == seen["overrides"]
    assert (args.degraded, args.agent, False) == (seen["degraded"], seen["uav_id"], seen["collab"])


def test_diag_replay_matches_reference(env, monkeypatch):
    """``--no-oc --no-photo`` through both packages: the summary, and the
    replay per frame to 1e-6."""
    runs = _Runs(monkeypatch, env["root"])
    monkeypatch.setattr(ar, "ensure_dataset", _small_ensure_dataset(ar.ensure_dataset))
    argv = ["--no-oc", "--no-photo", "--frames", str(N_FRAMES), "--duration", str(DURATION)]
    ref = json.loads(_reference_main(rd, argv, monkeypatch).strip().splitlines()[-1])
    got = td.run(td.parse_args(argv), H, W, CPU)
    _assert_replay_close(runs.outs["port"][0], runs.outs["jax"][0], "diag")
    assert runs.counters["port"][0] == runs.counters["jax"][0]
    got, ref = dict(got), dict(ref)
    got.pop("wall_s"), ref.pop("wall_s")
    _assert_rounded_close(got, ref, "diag",
                          dict(ate=4, ate_aligned=4, final_err=4, mean_nees=2, max_nees=1))
    assert got["overrides"]["obs_constrained"] is False and got["overrides"]["photometric"] is None


# ---------------------------------------------------------------------------
# (e) photometric ablation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ablation_overrides(env):
    """The overrides the reference's ablation passes per mode (its replays
    stubbed), and its verdict line on the stubbed results."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        def capture(meta, degraded, words, ccfg, uav_id, collab, overrides=None):
            seen[len(seen)] = (degraded, uav_id, collab, overrides)
            return len(seen)

        ates = {1: 0.5, 2: 0.4, 3: 0.3}
        mp.setattr(ar, "build_agent", capture)
        mp.setattr(ar, "replay", lambda agents, *a, **k: dict(
            ate_aligned=[ates[agents[0]]], ate=[1.0], mean_nees=[2.0], n_reinits=[0]))
        text = _reference_main(rp, ["--duration", str(DURATION)], mp)
    modes = ("off", "global", "spatial")
    return {m: seen[i] for i, m in enumerate(modes)}, json.loads(text.strip().splitlines()[-1]), ates


def test_photometric_modes_match_reference(ablation_overrides):
    """Each mode's overrides, and the verdict on the same results."""
    seen, verdict, ates = ablation_overrides
    for mode, (degraded, uav_id, collab, overrides) in seen.items():
        assert (degraded, uav_id, collab) == (False, 0, False)
        assert overrides == dict(sigma_img_px=14.0, photometric=tp.PHOTOMETRIC[mode]), mode
    results = {m: dict(ate_aligned=ates[i + 1]) for i, m in enumerate(seen)}
    assert tp.verdict(0.30, results) == verdict


@pytest.mark.parametrize("mode", ["off", "global", "spatial"])
def test_ablation_build_agent_matches_reference(env, ablation_overrides, mode):
    """The facade each package builds for ``mode``: its ``VioParams``,
    tracker, camera, photometric configuration and health monitor."""
    overrides = ablation_overrides[0][mode][3]
    jv = ar.build_agent(env["vign"], False, None, None, 0, collab=False, overrides=overrides)
    tv = tar.build_agent(env["vign"], False, None, None, 0, collab=False, overrides=overrides,
                         device=CPU)
    assert port_params(jv.params) == tv.params
    jt = jv._tracker_params._asdict()
    for k in ("use_pallas", "use_pallas_fast"):  # the reference's kernel switches, unset
        assert jt.pop(k) is None
    assert jt == tv._tracker_params._asdict()
    assert tuple(jv._camera) == tuple(tv._camera)
    assert jv._health == tv._health
    assert (getattr(jv, "_photo_state", None) is None) == (tv.photo is None)
    if tv.photo is not None:
        cfg = tv._photo_cfg
        assert jv._photo_dims == tuple(cfg.dims)
        assert jv._photo_eps == (cfg.epsilon_gap, cfg.epsilon_base)
        sp = jv._photo_spatial
        assert (sp is None) == (tv.photo.spatial is None)
        if sp is not None:
            assert (sp["cell_px"], sp["ncx"], sp["ncy"], sp["every"]) == \
                (cfg.cell_px, cfg.n_cells_x, cfg.n_cells_y, cfg.spatial_every)
            assert sp["valid"].shape[-1] == tv.photo.spatial.valid.shape[-1]


def test_ablation_off_replay_matches_reference(env, monkeypatch):
    """Mode ``off`` through both packages: its JSON line, and the replay per
    frame to 1e-6."""
    runs = _Runs(monkeypatch, env["root"])
    argv = ["--modes", "off", "--frames", str(N_FRAMES), "--duration", str(DURATION)]
    ref = json.loads(_reference_main(rp, argv, monkeypatch).strip().splitlines()[-1])
    got = tp.main(argv, h=H, w=W, device=CPU)
    _assert_replay_close(runs.outs["port"][0], runs.outs["jax"][0], "ablation off")
    _assert_rounded_close(got["off"], ref["off"], "ablation off",
                          dict(ate=4, ate_aligned=4, mean_nees=2))


# ---------------------------------------------------------------------------
# (f) the collaboration gate bisect
# ---------------------------------------------------------------------------


def _parse_gates(text: str) -> dict:
    """The reference bisect's printed counts, in the port's record."""
    def one(pattern, cast=int):
        m = re.search(pattern, text, re.M)
        return None if m is None else cast(m.group(1))

    out = dict(
        own_valid=one(r"own slam slots valid: (\d+)"), peer_valid=one(r"\| peer: (\d+)"),
        n_knn=one(r"stage kNN\(ratio\+abs\): (\d+)"),
        variants={k: int(n) for k, n in re.findall(r"^variant (\S+)\s*: n_applied = (\d+)", text, re.M)},
        keyframes_b=one(r"keyframes in B: (\d+)"), hit=one(r"\| hit: (\S+)", lambda s: s == "True"),
        rr_fused=one(r"rr fused via served keyframe: (\d+)"),
    )
    if "kf slam_desc_valid" in text:
        out["kf_probe"] = dict(
            kf_desc_valid=one(r"kf slam_desc_valid: (\d+)"), kf_knn=one(r"kNN ok: (\d+)"),
            kf_landmark_valid=one(r"kf landmark_valid: (\d+)"),
            kf_time=one(r"kf time: (\S+)", float), fs_tail_time=one(r"fs tail: (\S+)", float),
            after_ransac=one(r"after ransac: (\d+)"),
            variants={k: int(n) for k, n in
                      re.findall(r"^KF variant (\S+)\s*: n_applied = (\d+)", text, re.M)},
        )
    return out


@pytest.fixture(scope="module")
def gates(env):
    """The reference's bisect (``main``, its vocabulary the random words)
    and the port's (with the keyframe probe) on the same two agents after
    ``GATE_FRAMES`` frames; the ``CollabConfig`` of every fusion the
    reference's script calls itself."""
    import types

    with pytest.MonkeyPatch.context() as mp:
        _Runs(mp, env["root"])
        mp.setattr(ar, "ensure_dataset", _small_ensure_dataset(ar.ensure_dataset))
        mp.setattr(jvocab, "load_dbow3", lambda path: types.SimpleNamespace(words=_jax_words()))
        calls, fuse = [], jcollab.fuse_with_peer_desc

        def fuse_recorded(params, ccfg, fs, slots, peer, peer_valid, recency=None):
            if peer_valid is True:  # the script's own calls, not the receive's
                calls.append(ccfg)
            return fuse(params, ccfg, fs, slots, peer, peer_valid, recency=recency)

        mp.setattr(jcollab, "fuse_with_peer_desc", fuse_recorded)
        mp.delenv("KF_PROBE", raising=False)
        text = _reference_main(rg, ["--frames", str(GATE_FRAMES)], mp)
        ccfg = tg.collab_config()
        va, vb = tg.replay_pair(env["metas"], tar.make_words("random", CPU), ccfg, GATE_FRAMES,
                                CPU)
    # copies of the same two states (as the CLI's --cpu-check makes them),
    # drawing what the originals draw
    copies = [tg.clone_agent(v, env["metas"][a], a, CPU) for v, a in zip((va, vb), tg.AGENTS)]
    for c, v in zip(copies, (va, vb)):
        c.sampler = v.sampler
    port = tg.bisect(va, vb, ccfg, kf_probe=True)
    return dict(jax=_parse_gates(text), port=port, copies=tg.bisect(*copies, ccfg), jax_ccfgs=calls,
                text=text)


def test_gate_bisect_matches_reference(gates):
    """The kNN count, each variant's matches applied, B's keyframes, the
    hit and the served keyframe's receive, exactly; every variant's
    covariance finite and symmetric with a positive position block."""
    got, ref = gates["port"], gates["jax"]
    for k in ("own_valid", "peer_valid", "n_knn", "variants", "keyframes_b", "hit", "rr_fused"):
        assert got[k] == ref[k], (k, got[k], ref[k], gates["text"])
    assert got["n_knn"] > 0 and got["hit"], got
    for name, c in got["cov"].items():
        assert c["finite"] and c["max_asym"] <= 1e-9 * c["max_abs"] and c["min_pos_eig"] > 0, name


def test_gate_bisect_keyframe_probe(gates):
    """The port's probe of the served keyframe (``KF_PROBE``; the
    reference's run here leaves it out, its seven eager fusions cost more
    than the rest of its bisect): its counts bound one another, the
    keyframe is older than A's tail, and each variant fused from it."""
    got = gates["port"]["kf_probe"]
    assert 0 <= got["after_ransac"] <= got["kf_knn"] <= got["kf_desc_valid"]
    assert got["kf_landmark_valid"] > 0 and got["kf_time"] <= got["fs_tail_time"]
    assert list(got["variants"]) == list(tg.VARIANTS)
    ccfg = tg.collab_config()
    assert all(0 <= n <= ccfg.match_budget for n in got["variants"].values())
    assert "kf_probe" not in gates["jax"]


def test_gate_bisect_on_copies_of_the_states(gates):
    """``clone_agent``'s copies of A and B give the same bisect."""
    got, ref = gates["copies"], gates["port"]
    for k in ("own_valid", "peer_valid", "n_knn", "variants", "keyframes_b", "hit", "rr_fused"):
        assert got[k] == ref[k], (k, got[k], ref[k])


def test_gate_bisect_thermal_vocabulary_names_the_missing_file(monkeypatch, tmp_path):
    missing = str(tmp_path / "Vocabulary" / "thermal_voc_3_4_dbow3_calib.yaml")
    monkeypatch.setattr(tar, "THERMAL_VOCAB", missing)
    with pytest.raises(FileNotFoundError, match="thermal_voc_3_4_dbow3_calib.yaml"):
        tg.run(frames=1, vocab="thermal", device=CPU)
    assert tg.parse_args([]).vocab == "random" and tg.parse_args([]).frames == 120


# ---------------------------------------------------------------------------
# (g) no JAX; the card by default
# ---------------------------------------------------------------------------


def test_studies_never_import_jax():
    code = (
        "import runpy, sys\n"
        "for name in ('harsh_recovery', 'photometric_ablation', 'diag_solo', 'debug_collab_gates'):\n"
        "    sys.argv = [name, '--help']\n"
        "    try:\n"
        "        runpy.run_path(f'scripts/{name}_torch.py', run_name='__main__')\n"
        "    except SystemExit:\n"
        "        pass\n"
        "from x_multi_agent_torch.utils import diag_solo, harsh_recovery\n"
        "assert diag_solo.overrides_from_args(diag_solo.parse_args(['--no-photo']))\n"
        "assert harsh_recovery.parse_args([]).presets == 'harsh,extreme'\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('jax', 'x_multi_agent_tpu', 'bench')))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    for flag in ("--cheap-imu", "--modes", "--no-oc", "--vocab"):
        assert flag in out.stdout, flag


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card error")
def test_studies_default_to_the_card(env):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        th.run(env["harsh"], 0, True, 1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tp.run_mode(env["vign"], "off", 1, 14.0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        td.run(td.parse_args(["--frames", "1", "--duration", str(DURATION)]), H, W)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tg.run(frames=1, duration=DURATION, h=H, w=W)


# ---------------------------------------------------------------------------
# (h) on the card (``gpu``-marked, skipped here)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_studies_on_the_card(tmp_path, monkeypatch):
    """The studies at 480x640 on the card, their datasets rendered into
    ``tmp_path``: harsh recovery (preset harsh, the cheap IMU, 6 s, the
    camera black over frames 15-39) re-initializes no agent with the health
    monitor off and at least once with it on, every position finite; the
    photometric ablation's three modes (3 s) keep every position finite;
    the gate bisect (30 frames, the random vocabulary) finds a kNN match
    and leaves every variant's covariance finite, symmetric and positive on
    the position block; K1, K2 and the track rows launched."""
    import math

    from x_multi_agent_torch.vio.updates import track_rows
    from x_multi_agent_torch.vision import fast, lk

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(tar, "DATASET_ROOT", str(tmp_path))
    dev, h, w, duration, frames = torch.device("cuda"), 480, 640, 6.0, 60
    kernels = (fast.K1, lk.K2, track_rows.TRACK_ROWS)
    before = [k.launches for k in kernels]
    meta = th.ensure_harsh_dataset(0, duration, "harsh", cheap_imu=True, h=h, w=w, device=dev)
    off, on = (th.run(meta, 0, health, frames, cheap_imu=True, outage=(15, 40), device=dev)
               for health in (False, True))
    assert off["n_reinits"] == 0 and on["n_reinits"] >= 1, (off, on)
    assert math.isfinite(on["ate"]), on  # the RMS of the errors: finite iff every position is
    ab = tp.main(["--duration", "3", "--frames", "30"], h=h, w=w, device=dev)
    assert all(math.isfinite(ab[m]["ate"]) for m in ("off", "global", "spatial")), ab
    g = tg.run(30, "random", duration, h, w, device=dev, kf_probe=False)
    assert g["n_knn"] >= 1, g
    for name, c in g["cov"].items():
        assert c["finite"] and c["max_asym"] <= 1e-6 * c["max_abs"] and c["min_pos_eig"] > 0, name
    n_k1, n_k2, n_rows = (k.launches - n for k, n in zip(kernels, before))
    assert n_k1 >= 1 and n_k2 >= 3 * frames and n_rows >= 3, (n_k1, n_k2, n_rows)
