"""PyTorch port: the recorder (``utils/timing.py``).

On the CPU a device stamp is a host-clock record at the same place, so these
tests hold the recorder's structure on the main path: nothing recorded and
no stamp kernel asked for while it is off; with it on, the spans of one image
frame nested under one frame identifier, the stage stamps in stream order,
the counters, the clock calibration against a fake device clock, a ring's
overflow and a device gap's attribution. The ``gpu`` tests (on the card,
``python -m pytest --noconftest -m gpu tests/test_torch_timing.py``) hold the
stamps as the first and last node of a captured graph and the graph of a
program captured with the recorder off as it was without the recorder.
"""
import ctypes
import time

import numpy as np
import pytest
import torch

from x_multi_agent_torch import configs, native
from x_multi_agent_torch.parallel import mesh as tmesh
from x_multi_agent_torch.utils import bench as tbench
from x_multi_agent_torch.utils import graph, timing, tree
from x_multi_agent_torch.vio import pipeline as tpipe
from x_multi_agent_torch.vio import vio as tvio
from x_multi_agent_torch.vio.frame_step import CompiledFrameStep
from x_multi_agent_torch.vision import tracker as ttrk

A, H, W = 2, 96, 128
STAGES = ("flow", "ransac", "matches", "detect", "keep", "imu", "rows", "apply")


@pytest.fixture
def recorder():
    """The recorder off and empty before and after the test."""
    timing.disable()
    timing.start()
    yield timing
    timing.disable()
    timing.start()


@pytest.fixture(scope="module")
def image_frames():
    return tbench.orbit_frames(A, 2, H, W, device="cpu")


def _image_step(device="cpu"):
    tp = configs.flagship_tracker(24)._replace(n_feat_min=20)
    params = configs.flagship_params(small=True)
    step = CompiledFrameStep(params, tp, configs.flagship_camera(H, W))
    fs, slots = tvio.init_at_time(params, 0.0, A, device)
    return step, [ttrk.TrackerState.zero(tp, A, H, W, device=device), fs, slots]


def _run_image(step, state, frames, k):
    imgs, (times, seqs, ws, as_, mt) = frames[0][k], [x[k] for x in frames[1]]
    state[0], state[1], state[2], _, _ = step(*state, imgs, times, seqs, ws, as_, mt)


def _match_inputs(params, n, device="cpu"):
    x = tbench.match_inputs_stacked(params, A, n, np.random.default_rng(0), device=device)
    return [tree.map_leaves(lambda v: v[k], x) for k in range(n)]


def _run_match(prog, params, state, x):
    meas = tpipe.FrameMeasurement.from_matches(params.cfg, x[5])
    state[0], state[1], _ = prog(state[0], state[1], *x[:5], meas)


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s[1] == i]


def test_off_records_nothing_and_asks_for_no_stamp_kernel(recorder, image_frames, monkeypatch):
    def refuse(*_):
        raise AssertionError("the stamp kernel was asked for")

    monkeypatch.setattr(native, "lib", refuse)
    monkeypatch.setattr(timing, "_put", refuse)
    step, state = _image_step()
    launches = timing.STAMP.launches
    _run_image(step, state, image_frames, 0)
    got = timing.collect()
    assert got["spans"] == [] and got["intervals"] == [] and got["counters"] == {}
    assert got["frames"] == 0 and timing.STAMP.launches == launches


def test_image_frame_spans_nest_under_one_frame(recorder, image_frames):
    step, state = _image_step()
    recorder.enable()
    _run_image(step, state, image_frames, 0)
    got = recorder.collect()
    spans = got["spans"]
    assert got["frames"] == 1 and spans[0][0] == "frame" and spans[0][1] is None
    assert {s[4] for s in spans} == {0}  # one frame identifier
    assert all(s[2] <= s[3] for s in spans)
    top = _children(spans, 0)
    assert [spans[j][0] for j in top] == ["tracker", "measure", "filter"]
    tracker, _, filt = top
    assert [spans[j][0] for j in _children(spans, tracker)] == ["dispatch", "launch", "gate",
                                                                 "launch"]
    assert [spans[j][0] for j in _children(spans, filt)] == ["dispatch", "launch"]
    for parent in top:
        for j in _children(spans, parent):  # children lie inside their parent
            assert spans[parent][2] <= spans[j][2] <= spans[j][3] <= spans[parent][3]
    assert [spans[j][5] for j in _children(spans, filt)] == ["agent_step", "agent_step:0"]
    assert got["counters"] == {"host_syncs": 1, "detect_frames": 1}  # frame 0 detects


def test_stage_stamps_in_stream_order(recorder, image_frames):
    step, state = _image_step()
    recorder.enable()
    for k in range(2):
        _run_image(step, state, image_frames, k)
    got = recorder.collect()
    assert got["unmatched"] == 0 and got["lost_stamps"] == 0 and got["loose_stamps"] == 0
    for k in range(2):
        ivs = [iv for iv in got["intervals"] if iv[1] == got["intervals"][3 * k][1]]
        labels = [label for iv in ivs for label, _ in iv[4]]
        assert labels[:3] == ["flow", "ransac", "matches"]
        assert labels[3] in ("detect", "keep") and labels[4:] == ["imu", "rows", "apply"]
        assert [iv[0].split(":")[-1] for iv in ivs] == ["track", labels[3], "0"]
        for g, _, t0, t1, stages in ivs:  # inside its graph, in order
            ts = [t for _, t in stages]
            assert t0 <= ts[0] and ts == sorted(ts) and ts[-1] <= t1
    assert set(got["stage_ms"]) <= set(STAGES)
    assert got["host_calls"]["frame"] == 2 and got["counters"]["host_syncs"] == 2
    assert got["busy_ms"] == pytest.approx(sum(got["graph_ms"].values()))


def test_match_frame_makes_no_host_read(recorder):
    params = configs.flagship_params(small=True)
    prog = tmesh.agent_step_fn(params)
    state = list(tvio.init_at_time(params, 0.0, A, "cpu", v=np.asarray(tbench.SIM_V0)))
    xs = _match_inputs(params, 2)
    recorder.enable()
    for x in xs:
        _run_match(prog, params, state, x)
    got = recorder.collect()
    assert got["frames"] == 2 and got["counters"].get("host_syncs", 0) == 0
    spans = got["spans"]
    roots = [i for i, s in enumerate(spans) if s[1] is None]
    for r in roots:
        assert spans[r][0] == "frame"
        (filt,) = _children(spans, r)
        assert spans[filt][0] == "filter"
        assert [spans[j][0] for j in _children(spans, filt)] == ["dispatch", "launch"]
    assert [lab for iv in got["intervals"] for lab, _ in iv[4]] == ["imu", "rows", "apply"] * 2


@pytest.mark.parametrize("drift_ppm", [0.0, 40.0])
def test_calibration_recovers_a_known_offset(drift_ppm):
    """A fake device clock at a known offset (and drift) from the host's,
    read at a random point of each sample's host interval."""
    rng = np.random.default_rng(1)
    offset, host = -123_456_789_012, [10_000_000_000]

    def device_at(h):
        return int(h - offset + drift_ppm * 1e-6 * (h - 10_000_000_000))

    def sample():
        h0 = host[0]
        width = int(rng.integers(4_000, 60_000))
        host[0] += width + 1_000_000
        return h0, device_at(h0 + int(rng.integers(0, width + 1))), h0 + width

    first = timing.calibrate(sample, 32)
    host[0] += 50_000_000_000  # 50 s later
    last = timing.calibrate(sample, 32)
    for (o, half, d) in (first, last):
        assert half <= 30_000
        k = drift_ppm * 1e-6
        h = (d + offset + k * 10_000_000_000) / (1 + k)  # device_at's inverse
        assert abs(d + o - h) <= half + 1
    mid_host = 10_000_000_000 + 25_000_000_000
    t = device_at(mid_host)
    assert abs(timing.to_host(t, first, last) - mid_host) <= max(first[1], last[1]) + 1


def test_ring_overflow_is_reported(recorder, image_frames):
    step, state = _image_step()
    recorder.enable(capacity=4)
    _run_image(step, state, image_frames, 0)
    got = recorder.collect()
    # the tracker's graphs (a: 5 stamps, b: 3) and the filter's (5): 13 stamps, 4 kept
    assert got["lost_stamps"] == 9


def test_a_device_gap_goes_to_the_innermost_open_span(recorder):
    cpu = torch.device("cpu")
    recorder.enable()
    with timing.frame():
        with timing.span("launch", "g:0"):
            timing.bound("g:0", False, cpu)
            timing.bound("g:0", True, cpu)
        with timing.span("gate"):
            time.sleep(0.02)
        with timing.span("launch", "g:1"):
            timing.bound("g:1", False, cpu)
            timing.bound("g:1", True, cpu)
    got = recorder.collect()
    assert set(got["gap_ms"]) == {"gate"} and got["gap_ms"]["gate"] >= 20.0
    assert got["unmatched"] == 0 and got["gap_total_ms"] == got["gap_ms"]["gate"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ends(g: torch.cuda.CUDAGraph) -> tuple:
    """(root nodes' kernel names, leaf nodes' kernel names) of a captured
    graph, from libcuda's graph API."""
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetEdges(raw, None, None, ctypes.byref(n)) == 0
    src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetEdges(raw, src, dst, ctypes.byref(n)) == 0
    m = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(m)) == 0
    nodes = (ctypes.c_void_p * m.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(m)) == 0
    params, name = (ctypes.c_void_p * 16)(), ctypes.c_char_p()

    def kernel(node):
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        if kind.value != 0:
            return f"node type {kind.value}"
        assert cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) == 0
        func, kern = params[0], params[7]
        assert (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)) if func
                else cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern))) == 0
        return name.value.decode()

    has_in, has_out = set(dst[:n.value]), set(src[:n.value])
    roots = [kernel(x) for x in nodes[:m.value] if x not in has_in]
    leaves = [kernel(x) for x in nodes[:m.value] if x not in has_out]
    return roots, leaves


def _captured(prog):
    (_, g), = prog._built.values()
    return g.graph


@pytest.mark.gpu
def test_stamps_bracket_a_captured_graph(recorder, cuda):
    params = configs.flagship_params(small=True)
    xs = _match_inputs(params, 4, cuda)
    runs = {}
    for on in (False, True):
        if on:
            recorder.enable()
        prog = tmesh.agent_step_fn(params)
        state = list(tvio.init_at_time(params, 0.0, A, cuda, v=np.asarray(tbench.SIM_V0)))
        launches = timing.STAMP.launches
        for x in xs[:2]:
            _run_match(prog, params, state, x)
        if on:
            recorder.start()  # the capture's eager run and the first replay go
            for x in xs[2:]:
                _run_match(prog, params, state, x)
        events, names = graph._graph_nodes(_captured(prog))
        runs[on] = (events, names, timing.STAMP.launches - launches, _ends(_captured(prog)))
    (ev0, names0, n0, _), (ev1, names1, n1, (roots, leaves)) = runs[False], runs[True]
    # off: no stamp node, no stamp launched; the graph as it was without the recorder
    assert n0 == 0 and not any("stamp_kernel" in k for k in names0)
    stamps = sum(c for k, c in names1.items() if "stamp_kernel" in k)
    assert stamps == 5 and ev1 - stamps == ev0  # begin, imu, rows, apply, end
    assert ["stamp_kernel" in k for k in roots] == [True]
    assert ["stamp_kernel" in k for k in leaves] == [True]
    got = recorder.collect()
    assert got["unmatched"] == 0 and got["lost_stamps"] == 0 and got["frames"] == 2
    ivs = got["intervals"]
    assert [iv[0] for iv in ivs] == ["agent_step:0"] * 2
    for _, frame, t0, t1, stages in ivs:
        assert [lab for lab, _ in stages] == ["imu", "rows", "apply"]
        ts = [t0] + [t for _, t in stages] + [t1]
        assert ts == sorted(ts) and frame is not None
    clock = got["clock"][cuda.index or 0]
    assert clock["uncertainty_ns"] <= 20_000
