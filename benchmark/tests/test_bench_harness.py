"""The harness rehearsed on the CPU at tiny sizes: each traffic mix through a
short window, the result line's keys, the rings' continuity across their
wrap, the command's refusals, no JAX loaded, and new data files found by
name."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.tests import tiny
from benchmark.harness import inputs, main, manifest

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def sound():
    return {}


def _run(sound, cell):
    if cell not in sound:
        sound[cell] = tiny.run(cell)
    return sound[cell]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_each_mix_runs_a_tiny_window(sound, cell):
    out = _run(sound, cell)
    assert list(out) == KEYS + ["checks"]  # the compared numbers come last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0 and out["attempted"] % 2 == 0
    want = [m["name"] for m in manifest.cell(cell, tiny.root_for(cell))["end_to_end"]]
    assert sorted(out["metrics"]) == sorted(want)
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_frozen_reference_equals_the_port_on_the_cpu(sound, cell):
    """On the CPU both sides run the same plain code: every number reads 0."""
    checks = _run(sound, cell)["checks"]
    assert set(checks) >= {"filter_gap", "failed_agents"}
    assert ("track_off_share" in checks) == ("matches" not in cell)
    assert ("exchange_gap" in checks) == ("exchange" in cell)
    assert all(c["value"] == 0 for c in checks.values()), checks


def test_traced_line_has_per_layer_metrics_and_breakdown():
    out = tiny.run("flagship-fleet64-image", trace=True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert set(out["device"]) >= {"busy_s", "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    layer = {m["name"] for m in manifest.cell("flagship-fleet64-image")["per_layer"]}
    assert set(out["metrics"]) <= layer
    assert {"filter_ms_per_frame", "tracker_ms_per_frame", "launch_calls_per_frame"} <= set(
        out["metrics"])


def _orbit_mix():
    return json.load(open(manifest.BENCH_DIR / "traffic" / "fleet64-image.json"))


def test_orbit_closes_after_one_period():
    mix = _orbit_mix()
    period = mix["ring_frames"] / mix["cam_rate"]
    phase = torch.tensor([[0.3], [2.0]], dtype=torch.float64)
    fns = inputs.orbit(mix["orbit"], 2 * torch.pi / period, phase)
    t = torch.linspace(0, period, 37, dtype=torch.float64)[None]
    for fn in fns:
        assert torch.allclose(fn(t + period), fn(t), atol=1e-12)


@pytest.mark.parametrize("cell", ["flagship-fleet64-image", "flagship-fleet512-matches"])
def test_ring_continues_across_the_wrap(cell):
    c = manifest.cell(cell)
    ov = tiny.overrides(cell)
    config, mix = dict(c["config"]), dict(c["mix"])
    for k, v in ov.items():
        (config if k in config else mix)[k] = v
    if mix["input"] == "matches":
        mix["circle"] = dict(mix["circle"], pixel_noise=0.0, match_jitter=0.0)
    ring = inputs.make_ring(mix, 2, config, tiny.SEED, torch.device("cpu"))
    n, L = ring.imu_per_frame, ring.length
    f0, last, fl = ring.frame(0), ring.frame(L - 1), ring.frame(L)
    assert torch.allclose(fl["times"], f0["times"] + ring.period_s, atol=1e-5)
    assert torch.equal(fl["seqs"], f0["seqs"] + L * n)
    dt = 1.0 / (mix["cam_rate"] * n)
    assert torch.allclose(fl["times"][:, 0] - last["times"][:, -1], torch.tensor(dt), atol=1e-5)
    assert torch.equal(fl["seqs"][:, 0] - last["seqs"][:, -1], torch.ones(2, dtype=torch.int32))
    if mix["input"] == "image":
        assert torch.equal(fl["image"], f0["image"])
    else:  # frame 0 looks back at the view of the period's last frame
        assert torch.allclose(f0["prev_pt"], last["cur_pt"], atol=1e-6)


def _cli(args, cwd, env=None):
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {}))
    e.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def test_command_refuses_without_a_card():
    p = _cli(["--workload", "flagship-solo-matches", "--seed", str(tiny.SEED), "--seconds", "1",
              "--trace", "0"], tiny.ROOT)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_command_refuses_where_only_the_benchmark_is(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(["--workload", "flagship-solo-matches", "--seed", "1", "--seconds", "1",
              "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_jax_or_jax_package_is_loaded():
    code = ("import sys; from benchmark.tests import tiny; tiny.run('flagship-solo-matches', 1.0);"
            "from benchmark.harness.main import forbidden_modules;"
            "print(forbidden_modules(), 'x_multi_agent_torch' in sys.modules)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"
    assert main.FORBIDDEN == ("jax", "jaxlib", "flax", "x_multi_agent_tpu")
    # taken whole: the port's name begins with the JAX package's, and is not it
    sys.modules.setdefault("x_multi_agent_tpux_probe", sys)
    try:
        assert "x_multi_agent_tpux_probe" not in main.forbidden_modules()
    finally:
        del sys.modules["x_multi_agent_tpux_probe"]


JUDGE_LOADS_JAX = """
import sys, types
from benchmark.tests import tiny
from benchmark import run as cmd
from benchmark.harness import check, main

real = main.run
main.run = lambda w, seed, s, trace, t_start=None: real(
    w, seed, s, trace, device="cpu", overrides=tiny.overrides(w), t_start=t_start)
numbers = check.Judge.numbers
def numbers_loading_jax(self):
    if {load}:
        sys.modules["jax"] = types.ModuleType("jax")
    return numbers(self)
check.Judge.numbers = numbers_loading_jax
sys.argv = ["run.py", "--workload", "flagship-solo-matches", "--seed", "{seed}",
            "--seconds", "1", "--trace", "0"]
sys.exit(cmd.main())
"""


@pytest.mark.parametrize("load", [False, True])
def test_command_refuses_where_the_judge_loads_jax(load):
    """The look for JAX is the run's last step: a module the reference or
    the judge loads once the window has closed is caught, and the command
    exits 2 with no result line."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", JUDGE_LOADS_JAX.format(load=load, seed=tiny.SEED)],
                       cwd=tiny.ROOT, env=env, capture_output=True, text=True, timeout=300)
    if not load:
        assert p.returncode == 0, p.stderr[-2000:]
        assert list(json.loads(p.stdout.strip().splitlines()[-1])) == KEYS + ["checks"]
        return
    assert p.returncode == 2 and p.stdout.strip() == "", p.stderr[-2000:]
    assert "loaded once the window had closed: jax" in p.stderr


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import benchmark.reference.steps;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'x_multi_agent_torch', 'x_multi_agent_tpu', 'jax'}))")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def test_new_cell_traffic_limits_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(tiny.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests", "reference", "harness"))
    man = json.load(open(tiny.ROOT / "BENCHMARK.json"))
    bench = tmp_path / "benchmark"
    mix = json.load(open(bench / "traffic" / "solo-matches.json"))
    json.dump(dict(mix, checks=1), open(bench / "traffic" / "duo-matches.json", "w"))
    json.dump({"filter_gap": 1e-4}, open(bench / "limits" / "flagship-duo-matches.json", "w"))
    (bench / "metrics" / "frames_in_window.py").write_text(
        "def read(run):\n    return float(run.window.frames)\n")
    man["workloads"].append({"name": "flagship-duo-matches", "config": "flagship-m15n15-vga",
                             "traffic": "duo-matches", "chips": 1, "why": "a test cell"})
    man["per_layer"].append({"name": "frames_in_window", "unit": "frames", "better": "higher",
                             "source": "program_counter", "layer": "filter",
                             "moves": "agent_frames_per_s",
                             "workloads": ["flagship-duo-matches"]})
    json.dump(man, open(tmp_path / "BENCHMARK.json", "w"))
    out = main.run("flagship-duo-matches", tiny.SEED, 1.0, True, device="cpu",
                   overrides={"agents": 2, "trace_frames": 2}, root=tmp_path)
    assert out["correct"] is True
    assert out["metrics"]["frames_in_window"]["value"] * 2 == out["attempted"]
    # a metric that lists its cells reports in those alone
    assert "filter_ms_per_frame" not in out["metrics"]


def test_traffic_driver_is_found_by_name(tmp_path):
    """A traffic file that names a driver runs the hooks its module defines
    (here a window that counts its calls) and the harness's for the rest."""
    shutil.copytree(tiny.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests", "reference", "harness"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "benchmark"
    mix = json.load(open(bench / "traffic" / "solo-matches.json"))
    json.dump(dict(mix, driver="counted_window"), open(bench / "traffic" / "solo-matches.json", "w"))
    (bench / "drivers" / "counted_window.py").write_text(
        "from benchmark.harness.window import run as closed_loop\n"
        "CALLS = []\n\n\n"
        "def window(fleet, clock, first, seconds, sample_at):\n"
        "    CALLS.append(first)\n"
        "    return closed_loop(fleet, clock, first, seconds, sample_at)\n")
    out = main.run("flagship-solo-matches", tiny.SEED, 1.0, False, device="cpu",
                   overrides=tiny.overrides("flagship-solo-matches"), root=tmp_path)
    assert out["correct"] is True and out["attempted"] > 0
    assert sys.modules["benchmark.drivers.counted_window"].CALLS == [2]
    del sys.modules["benchmark.drivers.counted_window"]


def test_manifest_names_only_what_exists():
    """Every cell's configuration, traffic and limits file, every per-layer
    metric's reader, and every ``moves`` an end-to-end metric its cells
    report; every configuration used; keys as the manifest allows them."""
    man = manifest.load()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    bench = tiny.ROOT / "benchmark"
    cfgs = {c["name"]: c for c in man["configs"]}
    assert {w["config"] for w in man["workloads"]} == set(cfgs)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert sorted(json.load(open(tiny.ROOT / c["file"]))["reduced"]) == sorted(c["reduced"])
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (bench / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.load(open(bench / "limits" / f"{w['name']}.json"))
        assert "filter_gap" in limits
        cell = manifest.cell(w["name"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for w in man["workloads"]:
        mix = json.load(open(bench / "traffic" / f"{w['traffic']}.json"))
        assert "driver" not in mix or (bench / "drivers" / f"{mix['driver']}.py").exists()
    for m in man["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in man["workloads"]}
            assert w in e2e[m["moves"]].get("workloads", [w])
