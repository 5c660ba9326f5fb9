"""The benchmark programs of the reference's ``bench.py`` on the port: the
match-driven filter step batched over agents, its batch-1 latency, and the
image-driven frame step on 480x640 orbit frames.

Each program replays one input stream twice as long as its timed window: a
warm-up window, then the consecutive timed window of the same replay, with
every input staged on the device before it. As the reference times one
``jax.jit`` program per window, the steps are compiled programs
(``utils/graph.py``): the filter step is one CUDA graph per step
(``mesh.agent_step_fn``), the image step the tracker's graphs around its
detection gate and then that graph (``frame_step.CompiledFrameStep``); each
is captured on its first warm-up step, never in the timed window. The timed
window is the Python loop of those steps between two CUDA events with one
synchronize at the end (on a CPU device, which only the tests ask for, the
host clock; there the programs run their plain path). The reference's
health asserts stay; each raises ``AssertionError``.

Not ported (the reference's TPU-tunnel workarounds): ``measure_rtt``,
``_sync``'s scalar pull, ``_enable_compile_cache`` and ``main``'s retry
loop. ``scripts/bench_torch.py`` is ``main``.
"""
from __future__ import annotations

import functools
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from .. import configs
from ..device import resolve
from ..ekf import ekf as ekf_mod
from ..ops import linalg
from ..parallel.mesh import agent_step_fn
from ..vio import pipeline
from ..vio import track_manager as tm
from ..vio import vio as vio_mod
from ..vio.frame_step import CompiledFrameStep
from ..vision import tracker as trk
from . import tree
from .scene import orbit_dataset
from .sim import make_circle_sim

BASELINE_UPDATES_PER_S = 200.0  # the reference's generous C++ per-agent estimate
BASELINE_FRAMES_PER_S = 30.0  # camera-rate real time
SIM_V0 = (1.5 * 1.2, 0.0, 0.0)  # the circle sim's initial velocity (r * omega)


def card_line(device: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card (the line every
    number taken on it is tagged with), or None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=4)
def _circle_sim(j: int, n_round: int):
    return make_circle_sim(duration=(n_round + 1) / 10.0, imu_rate=100.0, cam_rate=10.0,
                           n_landmarks=60, match_budget=j, pixel_noise=5e-4, seed=7)


def bench_sim(j: int, n_frames: int):
    """The circle simulation behind the match-driven programs: wall
    landmarks with stable track ids, ``j`` matches per frame. Its length is
    rounded up to a multiple of 256 frames, so the warm-up and the timed
    windows (other ``n_frames``) replay one simulation."""
    return _circle_sim(j, -(-n_frames // 256) * 256)


def match_inputs_stacked(params: vio_mod.VioParams, n_agents: int, n_steps: int,
                         rng: np.random.Generator, frame0: int = 0, device=None):
    """(n_steps, A, ...) per-frame inputs from :func:`bench_sim` starting at
    frame ``frame0``: (times, seqs, w_m, a_m, meas_time, matches). The same
    numpy draws in the same order as the reference: 1e-5 IMU jitter on w and
    a, ~3 % of the matches dropped per frame (track churn), 1e-4 px jitter
    on prev and cur. Floats are the reference's float32 values, as
    ``params.dtype``."""
    device = resolve(device)
    n_imu, j = 10, params.cfg.tracks.n_matches
    sim = bench_sim(j, frame0 + n_steps)
    fsl = slice(frame0, frame0 + n_steps)
    # frame f takes IMU samples (f*10, (f+1)*10]
    idx = np.arange(frame0, frame0 + n_steps)[:, None] * n_imu + np.arange(1, n_imu + 1)[None, :]
    times = np.broadcast_to(sim.imu_t[idx][:, None, :], (n_steps, n_agents, n_imu)).astype(np.float32)
    seqs = np.broadcast_to(idx[:, None, :], (n_steps, n_agents, n_imu)).astype(np.int32)
    w = sim.imu_w[idx][:, None].astype(np.float32) + rng.normal(
        size=(n_steps, n_agents, n_imu, 3)).astype(np.float32) * 1e-5
    a = sim.imu_a[idx][:, None].astype(np.float32) + rng.normal(
        size=(n_steps, n_agents, n_imu, 3)).astype(np.float32) * 1e-5
    ids = np.broadcast_to(sim.match_id[fsl][:, None, :], (n_steps, n_agents, j))
    valid = sim.match_valid[fsl][:, None, :] & (rng.random((n_steps, n_agents, j)) > 0.03)
    prev = sim.match_prev[fsl][:, None].astype(np.float32) + rng.normal(
        size=(n_steps, n_agents, j, 2)).astype(np.float32) * 1e-4
    cur = sim.match_cur[fsl][:, None].astype(np.float32) + rng.normal(
        size=(n_steps, n_agents, j, 2)).astype(np.float32) * 1e-4

    def dev(x, dtype=params.tdtype):
        return torch.as_tensor(np.array(x), device=device).to(dtype)

    matches = tm.Matches.of(track_id=dev(ids, torch.int32), prev_pt=dev(prev), cur_pt=dev(cur),
                            valid=dev(valid, torch.bool))
    return dev(times), dev(seqs, torch.int32), dev(w), dev(a), dev(times[:, :, -1]), matches


def filter_step(params: vio_mod.VioParams, step=None):
    """One match-driven filter step, batched over the leading agent axis:
    ``process_imu_batch_impl``, then ``process_update_aux_impl`` over
    ``pipeline.visual_update``, through ``step`` (default: the compiled
    ``agent_step_fn(params)``; ``mesh.agent_step(params)`` is its eager
    twin). ``(fs, slots, times, seqs, w_m, a_m, meas_time, matches) -> (fs,
    slots, applied (A,))``; raises on CUDA when TF32 matmuls are on."""
    step = agent_step_fn(params) if step is None else step

    def one_step(fs, slots, times, seqs, w_m, a_m, meas_time, matches):
        linalg.require_fp32_matmul(fs.cov.device, "filter_step")
        meas = pipeline.FrameMeasurement.from_matches(params.cfg, matches)
        return step(fs, slots, times, seqs, w_m, a_m, meas_time, meas)

    return one_step


def _per_step(stacked) -> list:
    """(n_steps, ...) stacked inputs -> one tuple of (...) inputs per step."""
    n = stacked[0].shape[0]
    return [tree.map_leaves(lambda x: x[k], stacked) for k in range(n)]


def _clock(device: torch.device):
    """(start(), stop() -> seconds since start): CUDA events with one
    synchronize at the end on a card, the host clock on the CPU."""
    if device.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def start():
            torch.cuda.synchronize(device)
            ev[0].record()

        def stop():
            ev[1].record()
            torch.cuda.synchronize(device)
            return ev[0].elapsed_time(ev[1]) / 1e3

        return start, stop
    t0 = []
    return (lambda: t0.append(time.perf_counter())), (lambda: time.perf_counter() - t0[-1])


_KERNEL_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
_GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


def launch_calls(prof) -> tuple:
    """(kernel launches, graph launches) of a ``torch.profiler`` trace,
    counted on the host (the runtime's launch calls; the tracer can drop
    device events). Read from the tracer's raw events: building the trace's
    ``FunctionEvent`` tree takes seconds for an eager round's ~10^5 events,
    and gives the same names."""
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return (sum(n in _KERNEL_LAUNCH for n in names), sum(n in _GRAPH_LAUNCH for n in names))


def device_us(event) -> float:
    """Device time of one profiler event (the attribute was renamed across
    torch versions)."""
    for attr in ("device_time", "cuda_time", "self_device_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    raise AttributeError("profiler event has no device time")


def trace_calls(fn, reps: int, device: torch.device, graphs=(), names=()) -> dict:
    """``reps`` calls of ``fn(i)`` under ``torch.profiler``: per call, the
    wall ms (host clock, synchronized), the host's kernel launch calls and
    CUDA-graph launches, the device events the graphs of ``graphs``
    (``utils.graph.Graphs``) replayed, the device events the tracer kept and
    their summed device ms, and the device's idle share of the wall time
    (not measured on the CPU); over all calls, the device events whose name
    holds each of ``names`` (``named_events``). Where the tracer kept fewer device events
    than the host launched kernels plus the replayed graphs hold, it dropped
    some (or, where a graph's count is not known, may have): the device ms
    and the idle share are then None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    nodes0 = [g.replayed_nodes for g in graphs]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        if cuda:
            torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernel_calls, graph_calls = launch_calls(prof)
    nodes = [g.replayed_nodes for g in graphs]
    graph_nodes = (None if None in nodes0 + nodes
                   else sum(b - a for a, b in zip(nodes0, nodes)) / reps)
    rec = {"wall_ms": wall_ms, "launch_calls": kernel_calls / reps,
           "graph_launches": graph_calls / reps, "graph_nodes": graph_nodes}
    if cuda:
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(device_us(e) for e in kernels) / 1e3 / reps
        rec.update(kernel_events=len(kernels) / reps, device_busy_ms=None, device_idle_share=None,
                   named_events={n: sum(n in e.name for e in kernels) for n in names})
        held = rec["launch_calls"] + (graph_nodes or 0.0)
        if (graph_nodes is not None or not graph_calls) and rec["kernel_events"] >= held:
            rec.update(device_busy_ms=busy, device_idle_share=1.0 - busy / wall_ms)
    return rec


def _timed_stats(stats: dict, elapsed: float, n_steps: int) -> None:
    """The timed window's seconds and ms per step into ``stats``, and where
    the steps were traced on a card, the device's idle share of a timed
    step (the tracer's own host cost inflates the traced steps' wall time,
    not their device time); None where the trace dropped device events."""
    stats.update(seconds=elapsed, ms_per_step=elapsed / n_steps * 1e3)
    trace = stats.get("trace", {})
    if "device_busy_ms" in trace:
        busy = trace["device_busy_ms"]
        stats["device_idle_share"] = None if busy is None else 1.0 - busy / stats["ms_per_step"]


def _match_replay(params, n_agents, n_steps, device, stats, traced):
    """Warm-up window, then the timed window, of one match-driven replay;
    the last ``traced`` warm-up steps under :func:`trace_calls` (into
    ``stats["trace"]``). Checks the reference's health asserts. Returns the
    timed window's seconds."""
    fs, slots = vio_mod.init_at_time(params, 0.0, n_agents, device, v=np.asarray(SIM_V0))
    rng = np.random.default_rng(0)
    compiled = agent_step_fn(params)
    step = filter_step(params, compiled)
    warm = _per_step(match_inputs_stacked(params, n_agents, n_steps, rng, device=device))
    timed = _per_step(match_inputs_stacked(params, n_agents, n_steps, rng, frame0=n_steps,
                                           device=device))
    n_untraced = n_steps - min(traced, n_steps)
    for x in warm[:n_untraced]:
        fs, slots, applied = step(fs, slots, *x)
    if n_untraced < n_steps:
        def one(i):
            nonlocal fs, slots
            fs, slots, _ = step(fs, slots, *warm[n_untraced + i])

        stats["trace"] = trace_calls(one, n_steps - n_untraced, device, (compiled.graphs,))
    start, stop = _clock(device)
    start()
    for x in timed:
        fs, slots, applied = step(fs, slots, *x)
    elapsed = stop()

    sim = bench_sim(params.cfg.tracks.n_matches, 2 * n_steps)
    n_app = int(applied.sum())
    n_feat = int(fs.vision.n_valid_features.min())
    err = float(torch.linalg.norm(
        ekf_mod.tail_core(fs).p.double().cpu() - torch.from_numpy(sim.cam_p[2 * n_steps - 1]),
        dim=-1).max())
    _timed_stats(stats, elapsed, n_steps)
    stats.update(applied_last=n_app, min_slam_features=n_feat, max_tail_err_m=err)
    if not bool(torch.isfinite(fs.cov).all()):
        raise AssertionError("filter covariance not finite")
    if n_app < 0.95 * n_agents:
        raise AssertionError(f"only {n_app}/{n_agents} updates applied in the last step")
    if n_feat <= 0:
        raise AssertionError("no SLAM features initialized under sim-driven load")
    if not err < 1.0:
        raise AssertionError(f"filter lost the sim trajectory (max err {err:.2f} m)")
    return elapsed


def bench_matches(params: vio_mod.VioParams, n_agents: int, n_steps: int, device=None,
                  stats: Optional[dict] = None, traced: int = 0) -> float:
    """Updates per second of the match-driven filter step (10 IMU samples
    and one visual update per agent and step) at ``n_agents``: ``n_steps``
    warm-up steps, then ``n_steps`` timed ones of the same replay. Asserts
    the reference's health gates after the timed window: >= 95 % of the
    agents applied their update in the last step, every agent holds a SLAM
    feature, every tail position lies within 1 m of the simulation's, the
    covariance is finite. ``stats`` (a dict) receives the window's seconds,
    ms per step and those health numbers; ``traced`` > 0 traces the last
    warm-up steps (:func:`trace_calls`, into ``stats["trace"]``) and, on a
    card, adds the device's idle share of a timed step."""
    device = resolve(device)
    stats = {} if stats is None else stats
    elapsed = _match_replay(params, n_agents, n_steps, device, stats, traced)
    return n_agents * n_steps / elapsed


def bench_batch1_latency(params: vio_mod.VioParams, n_steps: int = 100, device=None,
                         stats: Optional[dict] = None, traced: int = 0) -> float:
    """Milliseconds per update of a single agent: :func:`bench_matches` at
    A = 1 (``n_steps`` warm-up, then ``n_steps`` timed), its health asserts
    included."""
    device = resolve(device)
    stats = {} if stats is None else stats
    return _match_replay(params, 1, n_steps, device, stats, traced) / n_steps * 1e3


def orbit_frames(n_agents: int, n_frames: int, h: int, w: int, device=None):
    """(n_frames, A, h, w) float32 frames of the textured wall along each
    agent's 6-DoF orbit (fx = fy = 0.8 w), rendered on the device one frame
    of all agents at a time (``scene.orbit_dataset``: the port's renderer,
    gray levels truncated as the dataset writer stores them), and per frame
    the IMU windows (times, seqs, w_m, a_m, meas_time): (n_frames, A, 10,
    ...) and meas_time (n_frames, A)."""
    frames, (times, seqs, ws, as_) = orbit_dataset(n_agents, n_frames, h, w, resolve(device))
    return frames, (times, seqs, ws, as_, times[:, :, -1])


def bench_image(params: vio_mod.VioParams, n_agents: int, n_steps: int, h: int = 480,
                w: int = 640, device=None, stats: Optional[dict] = None,
                traced: int = 0) -> float:
    """Agent-frames per second of the image-driven frame step: the tracker
    (pyramid, gated FAST through K1, pyramidal LK through K2, RANSAC) and
    the match-driven filter step, on 6-DoF orbit frames (pre-rendered, not
    timed) with ``configs.flagship_tracker`` and ``flagship_camera``.
    ``n_steps`` warm-up frames, then ``n_steps`` timed ones.

    As the reference's bench, every agent starts from ``init_at_time(params,
    0.0)`` (at rest at the origin), not at its orbit's true state: the bench
    asserts only the tracker's health and a finite covariance (>= 10 live
    features per agent in all, fps < 50 000), so it does not need the maps
    to agree, as fusion does. ``stats`` and ``traced`` as in
    :func:`bench_matches` (the frame step's launches then include K1/K2)."""
    device = resolve(device)
    stats = {} if stats is None else stats
    tparams = configs.flagship_tracker(params.cfg.tracks.n_matches)
    cam = configs.flagship_camera(h, w)
    n_warm = n_steps
    frames, imu = orbit_frames(n_agents, n_warm + n_steps, h, w, device)
    imu = [x.to(params.tdtype) if x.is_floating_point() else x for x in imu]
    fs, slots = vio_mod.init_at_time(params, 0.0, n_agents, device)
    tstate = trk.TrackerState.zero(tparams, n_agents, h, w, device=device)
    step = CompiledFrameStep(params, tparams, cam)

    def one(k):
        nonlocal tstate, fs, slots
        tstate, fs, slots, _, _ = step(tstate, fs, slots, frames[k], *(x[k] for x in imu))

    n_untraced = n_warm - min(traced, n_warm)
    for k in range(n_untraced):
        one(k)
    if n_untraced < n_warm:
        stats["trace"] = trace_calls(lambda i: one(n_untraced + i), n_warm - n_untraced, device,
                                     step.graphs)
    start, stop = _clock(device)
    start()
    for k in range(n_warm, n_warm + n_steps):
        one(k)
    elapsed = stop()

    n_live = int((tstate.ids >= 0).sum())
    fps = n_agents * n_steps / elapsed
    _timed_stats(stats, elapsed, n_steps)
    stats["live_features"] = n_live
    if n_live < n_agents * 10:
        raise AssertionError(f"tracker degenerate: {n_live} live features")
    if not bool(torch.isfinite(fs.cov).all()):
        raise AssertionError("filter covariance not finite")
    if not fps < 50_000:
        raise AssertionError(f"implausible frame rate {fps:.0f}/s - timing artifact")
    return fps
