"""The readers of the program's own recorder (``metrics/recorded.py`` and the
metrics of ``benchmark/record.py``) on the CPU at tiny sizes: a value from
each on the cells that list it, None where a run carries no recording, and
the recorder's steps doing nothing where the program has no recorder."""
from types import SimpleNamespace

import pytest

from benchmark.tests import tiny
from benchmark import record
from benchmark.harness import manifest, recorder

IMAGE, SOLO = "flagship-fleet64-image", "flagship-solo-matches"


@pytest.fixture(scope="module")
def recorded():
    return {cell: record.run(cell, tiny.SEED, 1.5, False, device="cpu",
                             overrides=tiny.overrides(cell), root=tiny.root_for(cell))
            for cell in (IMAGE, SOLO)}


def test_metrics_are_manifest_entries_with_readers():
    man = manifest.load()
    cells = {w["name"] for w in man["workloads"]}
    layers = {m["layer"] for m in man["per_layer"]}
    names = {m["name"] for m in man["per_layer"] + man["end_to_end"]}
    for m in record.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["name"] not in names and m["layer"] in layers
        assert m["moves"] == "agent_frames_per_s" and set(m["workloads"]) <= cells
        assert (manifest.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", [IMAGE, SOLO])
def test_each_reader_reads_the_recording(recorded, cell):
    rec = recorded[cell]["recorded"]
    mine = [m["name"] for m in record.METRICS if cell in m["workloads"]]
    assert sorted(rec["metrics"]) == sorted(mine)
    assert all(v is not None and v >= 0 for v in rec["metrics"].values()), rec["metrics"]
    assert rec["recorded_frames"] == rec["frames"]
    assert rec["metrics"]["host_syncs_per_frame"] == (1.0 if cell == IMAGE else 0.0)
    assert rec["lost_stamps"] == 0 and rec["unmatched"] == 0
    assert recorded[cell]["correct"] is True


def test_image_stages_split_the_graphs(recorded):
    rec = recorded[IMAGE]["recorded"]
    m = rec["metrics"]
    assert 0 <= m["detect_frames_share"] <= 100
    filt = sum(rec["stage_ms"][k] for k in ("imu", "rows", "apply"))
    assert filt == pytest.approx(rec["graph_ms"]["agent_step:0"], rel=0.02)


@pytest.mark.parametrize("name", [m["name"] for m in record.METRICS])
def test_readers_give_none_without_a_recording(name):
    read = manifest.reader(name)
    assert read(SimpleNamespace()) is None
    assert read(SimpleNamespace(program=None)) is None


def test_steps_do_nothing_without_the_recorder(monkeypatch):
    monkeypatch.setattr(recorder, "_timing", lambda: None)
    recorder.enable()
    recorder.start()
    assert recorder.collect() is None
    out = record.run(SOLO, tiny.SEED, 0.5, False, device="cpu", overrides=tiny.overrides(SOLO),
                     root=tiny.root_for(SOLO))
    assert "metrics" not in out["recorded"] and out["recorded"]["frames"] > 0
