#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``x_multi_agent_torch``) on one
NVIDIA card: the quickest proof that the port starts and is right there.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  0. card and build: print the card's name and power limit, require CUDA,
     turn TF32 off, build the CUDA kernels from ``x_multi_agent_torch/csrc``;
  1. K1 (FAST score + NMS) against its plain version on rendered frames at
     the slice's detection shapes (16x480x640 and 16x240x320) and at the
     single-agent facade's (1x480x640 and 1x240x320): exact;
  2. K2 (one LK level) against its plain version at the slice's three
     pyramid levels, 16 agents x 200 features, half_win 10, and once at
     half_win 15: ok flags agree on >= 99.5 % (disagreements only at the
     min-eigenvalue gate), |dflow| <= 2e-2 px where both are ok, >= 99 %
     within 1e-3 px;
  3. the slice: 16 agents x 30 frames of 480x640 (pre-rendered, not timed)
     through ``frame_step`` at the flagship dims, each agent started at its
     orbit's initial state: 10 warm-up frames, 20 frames timed with CUDA
     events; the image benchmark's asserts (live features >= 10 per agent,
     finite covariance), both kernels launched on this path, no JAX
     imported;
  4. K1 on one detection frame's two levels and K2 on one frame's three
     levels, per launch: the device time from a CUDA graph of 20 launches
     replayed between two CUDA events (``graph_ms``; fails unless the
     capture launched the kernel), the CUDA-event time of the calls (host
     enqueue included), the device time from a ``torch.profiler`` trace of
     the same calls (summed over the kernel's own symbol; "not measured"
     when the tracer kept no event), the plain version's time and the bound
     (the larger of the bytes over 3.35 TB/s and the operations over the
     fp32 peak, counted for these inputs: see ``k1_work`` and ``k2_work``);
  5. collaboration: a fresh fleet of the same 16 agents from their
     initial states through ``frame_step`` for 10 frames, with a full-map
     exchange round (``collab.collaborative_round``, the reference's
     default ``CollabConfig``) after the 5th and the 10th, each timed with
     CUDA events; matches fused (> 0 over both rounds), the covariance
     finite and symmetric with the smallest position-block eigenvalue
     printed, every tail position finite, K1 and K2 launched on this path
     (a fleet's first frame always detects; continuing phase 3's fleet
     instead, no agent falls below the detection threshold in 10 frames);
  6. the single-agent ``VIO`` facade (compiled: its programs run as CUDA
     graphs, as in phases 8, 9, 11 and 12) on agent 0's 30 frames and IMU:
     ``process_imu_batch`` + ``process_image_measurement`` with the health
     monitor on, timed with CUDA events; >= 90 % of the updates applied, no
     re-initialization, a finite tail, K1 launched on a (1, 480, 640)
     frame, K2 >= 3 launches per frame;
  7. the request-response fleet: a fresh fleet of the 16 agents with
     tracker descriptors on, 20 frames of ``frame_step``, each followed by
     ``collab.maybe_add_keyframe``; 64 words trained on the host
     (``train_kmajority``, seed 0) from the fleet's frame-0 descriptors; a
     ``request_response_round`` after the 15th and the 20th frame and a
     ``collaborative_msckf_round`` after the 20th, each timed with CUDA
     events (the reference's default ``CollabConfig``); keyframes, hits,
     matches fused, bytes shipped against a full broadcast, descriptor ms
     per frame and the descriptors' bit agreement with the CPU's float64
     ones (>= 99 %); asserts a keyframe, a hit, a fused match, a finite
     symmetric covariance, K1 and K2 launched on this path;
  8. the facade pair: agents 0 and 1 through two ``VIO`` facades for 30
     frames with descriptors and ``enable_collab``, an exchange every 3
     frames (``get_descriptors`` -> ``process_other_requests`` ->
     ``process_other_measurements``); ms per frame, keyframes, hits, fused
     and stored matches, matches consumed, bytes against full broadcast;
     asserts >= 90 % applied, no re-init, finite tails, a keyframe, a hit,
     a fused match, K1 on a (1, 480, 640) frame and K2 launched;
  9. the thermal facade: agent 0's 30 frames of phase 6 degraded on the card
     (``scene.degrade_frames``: gains a = 1 + 0.01 k, b = 0.002 k, vignette
     0.06, noise 0.006 from a seeded generator, uint8) through the facade
     with ``enable_photometric(n_obs=80)``, global gains only (run A) and
     with the spatial map (``cell_px=40, spatial_every=10``, run B), the
     health monitor on; ms per frame, the photometric update's own ms (CUDA
     events), and from a ``torch.profiler`` trace of 10 further updates its
     launch calls, graph launches, device-busy ms and idle share (10 more
     count the synchronizing operations), the gains against the baked ones
     at frames 10, 20 and 30; asserts >= 90 % applied, no re-init, a finite
     tail, the gains finite with a - b > 0 on every frame, K1 on a (1, 480,
     640) frame, K2 >= 3 launches per frame, no synchronizing operation in
     an update that solves no map, and in run B a solved finite map; in run
     A the corrected images of the last 10 frames closer to the clean
     render than the raw ones (run B's card against the CPU: phase 15);
 10. the multi-rank exchange (``parallel/mesh.py``): (a) 2 gloo ranks, both
     on the one card (``mesh.spawn_agents``), each run phase 7's fleet on
     its block of 8 agents (rendered in the rank) through
     ``frame_step.CompiledFrameStep`` with descriptors (K1/K2 launched from
     the tracker's graphs, counted from their kernel nodes) and the eager
     keyframe step for 20 frames, phase 7's words; then the round twins
     from the state after the last frame: ``EXCHANGE_ROUNDS`` rounds, each
     ``sharded_collab_round_desc`` then ``sharded_collab_round``, by the
     compiled programs (gloo: a graph per segment around each host-staged
     collective) and by their plain twins (``compiled=False``), every leaf
     of every output compared after every round; per twin and program ms
     per round (CUDA events; over the replays and over all rounds), kernel
     launch calls outside graphs and graph launches per round (a host-only
     ``torch.profiler`` trace), host syncs per round (the sync debug mode),
     graphs captured, capture seconds and pool bytes, and the bytes each
     twin shipped; the single-process rounds on the gathered pre-round
     states (the same keyed RANSAC draws) give the same integers and floats
     within 1e-4 of each leaf's max as the compiled first rounds; asserts >=
     90 % applied, finite covariances, K1 and K2 (>= 3 per frame) launched
     in each rank, a hit and a fused match, every round bit for bit, the
     twins' bytes equal, 3 and 2 graph launches per compiled descriptor and
     full-map round; (b) the same twins in this process at NCCL world size
     1 on all 16 agents: the compiled first rounds bit for bit the
     single-process rounds, every round bit for bit its plain twin, one
     graph per compiled round with its collective inside (1 graph launch,
     no host sync, fewer than 10 launch calls outside it); (c)
     ``dryrun.dryrun_multichip`` on 2 gloo ranks of 2 agents on the card
     (its rounds compiled), with its checks. The phase's wall time is
     printed;
 11. the dataset-replay ATE report (``utils/ate_report.py``) through
     ``run_report`` as its CLI runs it with ``--vocab random --duration
     3``: the thermal 6-DoF dataset of 4 agents at 480x640 rendered on the
     card into a temporary directory (removed afterwards), each agent
     replayed solo, then all four collaboratively with an exchange round
     after frames 19 and 29 over the 12 ordered pairs; per agent the
     aligned ATE solo and collaborative, mean NEES, re-inits and matches
     fused; hits and bytes against a full broadcast; ms per agent-frame
     of each pass (CUDA events from the first IMU batch to the report's
     last host read, exchange rounds taken out) and per exchange round;
     asserts every position finite, no re-init, the helpers' collaborative
     aligned ATE < 1 m, every ordered pair queried in every round, the
     full broadcast's bytes exactly the payload x 12 x 19, K1 on a (1, 480,
     640) frame and K2 >= 3 launches on every agent-frame after the first,
     no JAX imported; the NEES band and the collaborative gain are
     printed, not asserted; then K1 and K2 on the last frame's detection
     and LK levels of this path (A = 1; the compiled facades' frames
     replayed through the eager tracker from their kept tracker states,
     ``_KernelInputs``) against their plain versions under phases 1 and
     2's gates, and per launch as in phase 4. The phase's wall time is
     printed against its 180 s budget;
 12. the ATE-report studies (``utils/harsh_recovery.py``,
     ``photometric_ablation.py``, ``debug_collab_gates.py``) at 480x640 in
     a temporary dataset directory: harsh recovery (preset harsh, the
     degraded agent's cheap IMU, 6 s, the camera black over frames 15-39)
     with the health monitor off, then on; the photometric ablation's three
     modes (off, global, spatial) at 3 s on the vignette-0.30 dataset, with
     its verdict; the gate bisect after 30 frames of agents 0 and 2 with
     the random vocabulary (kNN count, matches applied under each of the
     seven gate variants, the served keyframe's receive); asserts no
     re-init with the monitor off and at least one with it on, every
     position finite (with the monitor on, and in every ablation mode), a
     kNN match, and after each variant a finite, symmetric covariance with
     a positive position block; K1 and K2 launched; then K1 and K2 on the
     harsh pass's last frame (timed as in phase 4) and on its black frame
     20 against their plain versions under phases 1 and 2's gates, and on
     an all-zero frame (no corner, no ``ok``, finite flows). The phase's
     wall time is printed against its 120 s budget; then the memory
     reserved (collected) before phase 11 and after phases 11 and 12, and
     every facade the two phases built gone with its graphs (weak
     references);
 13. the benchmark programs (``utils/bench.py``, the reference's
     ``bench.py``) at the reference's sizes: ``bench_matches`` at 512 and at
     128 agents (20 warm-up, then 20 timed steps), ``bench_batch1_latency``
     (100 + 100), ``bench_image`` at 64 agents on 480x640 frames (20 + 20),
     each with the reference's asserts (>= 95 % applied in the last step,
     SLAM features, tail within 1 m, finite covariance; >= 10 live features
     per agent, fps < 50 000); updates/s per chip and per agent, ms per
     step, frames/s, and from a ``torch.profiler`` trace of 3 warm-up steps
     the host's launch calls, device-busy ms and idle share per step; K1 and
     K2 launched by the image bench and by no match-driven program. The
     phase's wall time is printed against its 240 s budget. Every program
     is the compiled one (``utils/graph.py``: the
     filter step one CUDA graph per step, the image step the tracker's
     three graphs around its detection gate and the filter step's graph),
     captured on its first warm-up step; the trace counts CUDA-graph
     launches beside kernel launch calls, and the device events the graphs
     held;
 14. the compiled programs against the eager ones: the filter step at 512
     and at 1 agent on ``bench_sim``'s inputs from the bench's start, and
     the image frame step at 64 agents on 480x640 orbit frames of a fresh
     fleet started at rest, as the bench's; each compiled program first
     captures its graphs on its first inputs (the image step's detection graph on frame 0 and its keep graph
     on frame 1, so that the compared frame 0 runs K1 inside a replayed
     graph), then eager and compiled run 20 steps in turns from the same
     start on the same inputs: every leaf of the state and ``applied``
     bit for bit equal after every step, K1/K2 launched alike in both runs
     (the image step's at least once) and, in the compiled run, as often as
     the replayed graphs hold their kernels (read from the graphs' kernel
     nodes by function name; in the traced steps also the device events so
     named), no capture after the first inputs,
     one graph launch or more per traced step, every agent's covariance
     finite in both runs (the at-rest fleet that lost agent 44 before
     ROADMAP C20's repair) and the filter's updates applied; per program and run it prints ms per step
     (CUDA events over the same 20 steps), the host's kernel launch calls,
     graph launches, device events, device-busy ms and idle share from a
     ``torch.profiler`` trace of 3 more steps, the peak memory, and the
     graphs' capture seconds and pool bytes (``memory_reserved`` around
     the captures). The phase's wall time is printed against its 120 s
     budget. Then K1 and K2 on the eager image step's detection frame and
     last LK levels (A = 64; a graph keeps no consistent input after its
     frame) against their plain versions under phases 1 and 2's gates, K2's
     flows compared where ``lk.flow_sensitivity`` finds them stable (the
     kernels' edge-band tests' rule, ROADMAP C5), at least
     ``K2_STABLE_FLOOR`` of them (the count and the largest difference
     anywhere printed), and timed as in phase 4;
 15. the compiled facades against their eager twins (``VIO(...,
     compiled=False)``), each part twice from one start, the compiled run
     then the eager one per frame, every leaf compared after every frame:
     phase 6's facade, phase 8's pair (the store-aware update, the peer
     receive, the keyframe step) and phase 9's thermal facade B (30 frames
     each, the pair 15: its eager store-aware update is slow), and
     ``collaborative_round`` on phase 5's 16-agent fleet (4 rounds); per
     part, over the frames in which the compiled run captured nothing, ms
     per agent-frame (CUDA events; over all frames beside it), kernel
     launch calls outside graphs per agent-frame and graph launches per
     frame (a host-only ``torch.profiler`` trace of every compiled frame
     and of the eager run's last), host syncs per frame (the sync debug
     mode), captures, capture seconds and
     pool bytes, K1/K2 launches of each run (the compiled run's read from
     its graphs' kernel nodes), whether every covariance stayed finite
     (printed: a witness for ROADMAP C20, not a gate); asserts every frame bit for bit, K1/K2
     alike, fewer than 100 launch calls per agent-frame over the frames that
     captured nothing (their most printed), a graph launch per frame; then
     the thermal twin's last ``process_frame`` and spatial
     solve (its eager run's inputs) through the port on the CPU in
     float64: |da|, |db| <= 1e-4, the maps within 1e-3 once each connected
     component of the seen cells takes its own fitted offset (the centred
     difference and the mean offset printed). The phase's wall time is
     printed against its 240 s budget.

The last three lines of standard output are the kernels' JSON record (the
launch counts summed over the paths of phases 3, 5-9, 10's ranks, 11-15,
each read from 0 around its path, a graph's replays included; phase 4's
times per launch), the
card's ``nvidia-smi`` name and power limit, and the result JSON.
"""
import contextlib
import json
import os
import sys
import time
import weakref

N_AGENTS, H, W = 16, 480, 640
N_WARM, N_TIMED, N_COLLAB = 10, 20, 10
ROUND_EVERY = 5  # collaborative rounds after every 5th frame
N_FACADE = N_WARM + N_TIMED
N_RC, RC_ROUNDS = 20, (15, 20)  # request-response fleet: frames, rounds after these
N_WORDS, EXCHANGE_EVERY = 64, 3
N_RANKS = 2  # phase 10: gloo ranks of the multi-rank exchange, all on the one card
EXCHANGE_ROUNDS = 3  # phase 10: rounds of each twin (compiled and plain) from one start
ATE_DURATION, ATE_BUDGET_S = 3.0, 180.0  # phase 11: 30 frames per pass; its wall budget
# phase 12: the harsh pass's length, its camera blackout (frames) and the
# black frame whose kernel inputs are held; the ablation's length; the gate
# bisect's frames (of a dataset of STUDY_DURATION); the phase's wall budget
STUDY_DURATION, STUDY_OUTAGE, STUDY_BLACK_FRAME = 6.0, (15, 40), 20
STUDY_ABLATION_DURATION, STUDY_GATE_FRAMES, STUDY_BUDGET_S = 3.0, 30, 120.0
# phase 13: the benchmark programs' agent counts, windows (warm-up = timed),
# traced warm-up steps, and the phase's wall budget
BENCH_AGENTS, BENCH_POINT, BENCH_STEPS, BENCH_B1_STEPS = 512, 128, 20, 100
BENCH_IMG_AGENTS, BENCH_IMG_STEPS, BENCH_TRACED, BENCH_BUDGET_S = 64, 20, 3, 240.0
# phase 14: the compiled programs against their eager twins, (program,
# agents); the compared and timed steps, the traced steps after them, and
# the phase's wall budget; the first inputs that capture every graph of a
# program before the comparison (the image step: detection, then keep)
COMPILED_PROGRAMS = (("filter", 512), ("filter", 1), ("image", 64))
COMPILED_STEPS, COMPILED_TRACED, COMPILED_BUDGET_S = 20, 3, 120.0
COMPILED_PRIME = {"filter": 1, "image": 2}
# phase 15: the compiled facades against their eager twins: frames per
# facade part (the last TWIN_TRACED traced), full-map rounds, wall budget
# (the pair's eager store-aware update takes ~0.7 s per agent-frame: 15 frames,
# 5 exchanges, past the keyframe step's 10-frame wait)
TWIN_FRAMES, TWIN_PAIR_FRAMES, TWIN_ROUNDS, TWIN_BUDGET_S = N_FACADE, 15, 4, 240.0
# phase 14's K2 hold at A = 64 compares the flows that are stable (ROADMAP
# C5): at least this share of the flows both versions track
K2_STABLE_FLOOR = 0.95
# phase 9: the reference's thermal e2e drift, the accuracy report's vignette
# and noise, its calibration budget; spatial cells and cadence
THERMAL_GAINS = [(1.0 + 0.01 * k, 0.002 * k) for k in range(N_FACADE)]
THERMAL_VIGNETTE, THERMAL_NOISE, PHOTO_OBS = 0.06, 0.006, 80
CELL_PX, SPATIAL_EVERY = 40, 10
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 bytes/s, fp32
# flop/s outside the tensor cores (an FMA counts 2), and fp32 instructions/s
# that are not FMAs (min, max, compare, add: one per lane per clock)
PEAK_BYTES, PEAK_FLOPS, PEAK_OPS = 3.35e12, 67e12, 33.5e12


def _no_jax() -> None:
    """The port and this script import nothing of JAX."""
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")


def _ms(torch, fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after 2
    warm-up calls)."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed(torch, fn):
    """(fn(), milliseconds on the card by CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def profiler_ms(torch, fn, symbol: str, reps: int = 20, tries: int = 5):
    """Mean device milliseconds of the kernel whose name holds ``symbol``,
    from a ``torch.profiler`` trace of ``reps`` calls of ``fn`` (after a
    warm-up call), each launching it once. The tracer sometimes drops
    events (11 of 40 kept once, none of 20 in three traces once): the mean
    is over the launches it kept, the trace is taken again while it kept
    fewer than half, and when it keeps none it returns None (not
    measured)."""
    from torch.profiler import ProfilerActivity, profile

    from x_multi_agent_torch.utils.bench import device_us

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.name]
        if 2 * len(evs) >= reps:
            break
    if not evs:
        return None
    return sum(device_us(e) for e in evs) / 1e3 / len(evs)


def graph_ms(torch, fn, kernel, reps: int = 20, replays: int = 10) -> float:
    """Device milliseconds per launch of ``fn``, which launches ``kernel``
    once per call: ``reps`` calls captured in one CUDA graph (the wrappers
    launch on the current stream), the graph replayed ``replays`` times
    between two CUDA events, so no host work sits between the launches (the
    gaps between the graph's nodes are included). Fails unless the capture
    launched ``kernel`` ``reps`` times (its wrapper's counter)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = kernel.launches
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    if kernel.launches - n0 != reps:
        raise AssertionError(f"{kernel.name}: {kernel.launches - n0} launches captured, not {reps}")
    graph.replay()
    _, ms = _timed(torch, lambda: [graph.replay() for _ in range(replays)])
    if not ms > 0:
        raise AssertionError(f"{kernel.name}: no graph time ({ms} ms)")
    return ms / (reps * replays)


def k1_work(torch, fast, imgs, thr):
    """(bytes, fp32 operations) K1 needs on (A, H, W) images: each pixel
    read once and its score written once; 4 subtracts and 8 compares per
    interior pixel for the compass taps, 179 operations per pixel that
    passes them (16 subtracts, the 4-level min and max trees, 2 x 16
    reductions, the negation, the polarity max, the threshold), 8 max and
    1 compare per pixel for NMS."""
    a, h, w = imgs.shape
    n_cand = int(fast.compass_candidates(imgs, thr).sum())
    n_int = a * max(h - 6, 0) * max(w - 6, 0)
    return 8 * a * h * w, 12 * n_int + 179 * n_cand + 9 * a * h * w


def k2_work(torch, lk, args):
    """(bytes, flops) K2 needs for one level on these inputs: the distinct
    pixels of every feature's slabs in prev, gx and gy, and in the current
    image at the feature's guess and at its final flow (the iterations in
    between stay within a pixel or two of those), 4 bytes each, plus points,
    guesses, flows and flags; 39 flops per window pixel for the three
    windows and G, 16 per window pixel and Gauss-Newton step, with the steps
    each feature takes in the plain version."""
    prev, cur, dx, dy, pts, guess, half_win = args[:7]
    a, h, w = prev.shape
    k = pts.shape[1]
    flow, _, iters = lk._track_level(*args, return_iters=True)
    p, pad, n = 2 * half_win + 2, half_win + 1, (2 * half_win + 1) ** 2
    offs = torch.arange(p, device=pts.device)
    base = torch.arange(a, device=pts.device)[:, None, None, None] * (h * w)

    def footprint(pt):
        by = torch.clamp(torch.floor(pt[..., 1] - half_win).long() + pad, 0, h + 2 * pad - p)
        bx = torch.clamp(torch.floor(pt[..., 0] - half_win).long() + pad, 0, w + 2 * pad - p)
        rows = torch.clamp(by[..., None] + offs - pad, 0, h - 1)
        cols = torch.clamp(bx[..., None] + offs - pad, 0, w - 1)
        mask = torch.zeros(a * h * w, dtype=torch.bool, device=pts.device)
        mask[(base + rows[..., :, None] * w + cols[..., None, :]).reshape(-1)] = True
        return mask

    px_prev = int(footprint(pts).sum())
    px_cur = int((footprint(pts + guess) | footprint(pts + flow)).sum())
    nbytes = 4 * (3 * px_prev + px_cur) + a * k * (16 + 8 + 1)
    return nbytes, a * k * n * 39 + int(iters.sum()) * n * 16


def k2_agrees(stt) -> bool:
    """The gate K2 must pass against its plain version on one level
    (``lk.level_agreement``'s record), wherever it is held: the ``ok`` flags
    agree on >= 99.5 % of the features and differ only within 1e-3 of the
    gate, and where both are ok the flows agree within 2e-2 px, >= 99 % of
    them within 1e-3 px."""
    return (stt["ok_agree"] >= 0.995 and stt["max_disagree_margin"] <= 1e-3
            and stt["max_flow_err"] <= 2e-2 and stt["share_within_1e-3"] >= 0.99
            and stt["n_both_ok"] > 0)


def kernel_times(torch, fast, lk, det_levels, level_inputs, thr) -> dict:
    """K1 on one detection frame's levels and K2 on one frame's LK levels,
    per launch (means over the frame's launches): device ms from a CUDA
    graph of each launch site (:func:`graph_ms`), CUDA-event ms of the
    calls, profiler device ms (each level traced on its own; None where the
    profiler kept no event), the plain version's ms, the bound and what
    bounds it."""
    calls = {
        "fast": (fast.K1, "fast_score_nms_kernel",
                 [lambda i=i: fast.fast_score_nms(i, thr) for i in det_levels],
                 lambda: [fast.nms3(fast.fast_score(i, thr)) for i in det_levels],
                 [k1_work(torch, fast, i, thr) for i in det_levels], PEAK_OPS),
        "lk": (lk.K2, "lk_level_kernel",
               [lambda a=a: lk.track_level(*a) for a in level_inputs],
               lambda: [lk._track_level(*a) for a in level_inputs],
               [k2_work(torch, lk, a) for a in level_inputs], PEAK_FLOPS),
    }
    out = {}
    for name, (kernel, symbol, launches, plain, work, peak) in calls.items():
        n = len(work)
        t_bytes = sum(b for b, _ in work) / PEAK_BYTES * 1e3
        t_ops = sum(o for _, o in work) / peak * 1e3
        bound = sum(max(b / PEAK_BYTES, o / peak) for b, o in work) * 1e3 / n
        prof = [profiler_ms(torch, f, symbol) for f in launches]
        r = {"device_ms": sum(graph_ms(torch, f, kernel) for f in launches) / n,
             "ms": _ms(torch, lambda: [f() for f in launches]) / n,
             "profiler_ms": None if None in prof else sum(prof) / n,
             "plain_ms": _ms(torch, plain) / n, "bound_ms": bound,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None, "launches_per_frame": n,
             "bytes_per_frame": sum(b for b, _ in work), "ops_per_frame": sum(o for _, o in work)}
        r["share_of_bound"] = r["bound_ms"] / r["device_ms"]
        out[name] = r
    return out


def _profiled(r) -> str:
    return "not measured" if r["profiler_ms"] is None else f"{r['profiler_ms']:.4f} ms"


def _measured(x, digits: int) -> str:
    """A trace's number, or "not measured" where the trace dropped events."""
    return "not measured" if x is None else f"{x:.{digits}f}"


def kernel_inputs(torch, tparams, frame0, frame1):
    """The slice's kernel inputs from two (A, H, W) frames: their pyramids,
    frame 0's detection levels (K1's inputs) and the features detected on
    frame 0 and slotted as the tracker slots them (A, K, 2) (K2's points),
    with the mask of the slots that hold one."""
    from x_multi_agent_torch.vision import tracker
    from x_multi_agent_torch.vision.image import build_pyramid

    pyr0 = build_pyramid(frame0, tparams.lk_max_level)
    pyr1 = build_pyramid(frame1, tparams.lk_max_level)
    det_levels = [pyr0[lvl].contiguous() for lvl in range(tparams.pyramid_depth)]
    a, h, w = frame0.shape
    st = tracker.TrackerState.zero(tparams, a, h, w, device=frame0.device)
    cand = tracker._detect_new_batch(tparams, pyr0, st.pts, st.ids >= 0)
    st = tracker._integrate(tparams, st, frame0, st.ids >= 0, st.pts, *cand)
    return pyr0, pyr1, det_levels, st.pts.contiguous(), st.ids >= 0


def k2_level_inputs(torch, lk, tparams, pyr0, pyr1, pts, half_win):
    """The slice's K2 inputs at every level, coarsest first: ``pts`` tracked
    from pyramid ``pyr0`` into ``pyr1``, each level's guess from the plain
    version's coarser level. Returns [(args, plain (flow, ok))]."""
    from x_multi_agent_torch.vision.image import scharr_gradients

    out = []
    flow = torch.zeros_like(pts)
    for lvl in range(len(pyr0) - 1, -1, -1):
        dx, dy = scharr_gradients(pyr0[lvl])
        pts_l = (pts / 2.0**lvl).contiguous()
        flow = (flow * 2.0 if lvl < len(pyr0) - 1 else flow).contiguous()
        args = (pyr0[lvl].contiguous(), pyr1[lvl].contiguous(), dx.contiguous(),
                dy.contiguous(), pts_l, flow, half_win, tparams.lk_iters, tparams.min_eig_thr)
        ref = lk._track_level(*args)
        out.append((args, ref))
        flow = ref[0]
    return out


def _cov_health(torch, cov) -> dict:
    """Finiteness, largest asymmetry, largest entry and smallest
    position-block eigenvalue of (A, D, D) covariances."""
    pos = cov[:, :3, :3]
    return {
        "finite": bool(torch.isfinite(cov).all()),
        "max_asym": float((cov - cov.transpose(1, 2)).abs().max()),
        "max_abs": float(cov.abs().max()),
        "min_pos_eig": float(torch.linalg.eigvalsh(0.5 * (pos + pos.transpose(1, 2))).min()),
    }


class _Launches:
    """Reads the kernels' launch counters around one path: zero them just
    before it, read them just after."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.total = dict.fromkeys(kernels, 0)

    def start(self):
        for k in self.kernels.values():
            k.launches = 0

    def read(self) -> dict:
        got = {name: k.launches for name, k in self.kernels.items()}
        for name, n in got.items():
            self.total[name] += n
        return got


def run_collab(torch, params, tparams, cam, ccfg, start, frames, imu, n_frames, every, device):
    """A fleet started at ``start`` = (p, v, q) (A, ...) through
    ``frame_step`` for ``n_frames`` frames with a collaborative round after
    every ``every``-th. Returns (fs, per-round records, payload bytes of one
    agent)."""
    from x_multi_agent_torch.parallel import collab
    from x_multi_agent_torch.vio import vio
    from x_multi_agent_torch.vio.frame_step import frame_step
    from x_multi_agent_torch.vision import tracker

    a, h, w = frames.shape[1:]
    fs, slots = vio.init_at_time(params, 0.0, a, device, p=start[0], v=start[1], q=start[2])
    tstate = tracker.TrackerState.zero(tparams, a, h, w, device=device)
    times, seqs, w_ms, a_ms = imu
    rounds = []
    for k in range(n_frames):
        tstate, fs, slots, _, _ = frame_step(
            params, tparams, cam, tstate, fs, slots, frames[k], times[k], seqs[k],
            w_ms[k], a_ms[k], times[k][:, -1], seed=1,
        )
        if (k + 1) % every:
            continue
        (fs, n_matches), ms = _timed(torch, lambda: collab.collaborative_round(params, ccfg, fs))
        rounds.append({"ms": ms, "fused": int(n_matches.sum()),
                       "fused_per_agent": n_matches.sum(1).tolist(), **_cov_health(torch, fs.cov)})
    nbytes = collab.payload_nbytes(collab.extract_payload(params, fs))
    return fs, rounds, nbytes


def _per_frame(torch, n, fn) -> list:
    """``fn(k)`` for k < n, each frame between two CUDA events: its ms."""
    out = []
    for k in range(n):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn(k)
        ev[1].record()
        out.append(ev)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in out]


def _captures(vs) -> str:
    """The facades' compiled programs as printed: captures per program (one
    per capture key: ``process_imu_batch`` once per IMU window length, the
    photometric frame once per number of real histories), graphs, their
    capture seconds and pool bytes."""
    progs = [p for v in vs for p in v.programs]
    keys = {}
    for p in progs:
        keys[p.name] = keys.get(p.name, 0) + p.captures
    return (f"captures per program {json.dumps(keys)}, {sum(p.graphs.captured for p in progs)} "
            f"graphs in {sum(p.graphs.capture_s for p in progs):.3f} s, pools "
            f"{sum(p.graphs.pool_bytes for p in progs)} bytes")


def _frame_ms(ms, per: int = 1) -> str:
    """Per-frame ms (of ``per`` agents) as printed: the mean over all frames
    (the first capture the compiled facade's graphs) and over the frames
    after the first ``N_WARM``."""
    return (f"{sum(ms) / (len(ms) * per):.3f} ms per agent-frame over {len(ms)} frames, "
            f"{sum(ms[N_WARM:]) / (len(ms[N_WARM:]) * per):.3f} over frames {N_WARM + 1}-{len(ms)}")


def facade_path(params, tparams, cam, frames, imu, start, device, words=None, photometric=None):
    """One facade path as (``make(compiled)`` -> its facades from ``start``
    = (p, v, q) (A, ...), ``frame(vs, k, rec)`` driving frame ``k``) over
    the frames (n, A, H, W) and host IMU windows (numpy, (n, A, L, ...)):
    phase 6's facade (one agent), phase 8's collaborating pair (``words``:
    descriptors and ``enable_collab``, an exchange every ``EXCHANGE_EVERY``
    frames counted in ``rec``), phase 9's thermal facade (``photometric``:
    ``enable_photometric``'s keywords); the health monitor on."""
    from x_multi_agent_torch.vio.vio import VIO

    times, seqs, w_ms, a_ms = imu
    n_agents = frames.shape[1]

    def make(compiled=True):
        vs = []
        for uav in range(n_agents):
            v = VIO(params, device=device, compiled=compiled)
            v.init_at_time(0.0, p=start[0][uav], v=start[1][uav], q=start[2][uav])
            v.setup_tracker(tparams, cam, frames.shape[-2], frames.shape[-1], seed=uav)
            v.enable_health_monitor()
            if photometric is not None:
                v.enable_photometric(**photometric)
            if words is not None:
                v.enable_collab(words, uav_id=uav, seed=10 + uav)
            vs.append(v)
        return vs

    def frame(vs, k, rec):
        for uav, v in enumerate(vs):
            v.process_imu_batch(times[k][uav], seqs[k][uav], w_ms[k][uav], a_ms[k][uav])
            rec["applied"] = rec.get("applied", 0) + v.process_image_measurement(
                float(times[k][uav][-1]), k, frames[k][uav])
        if words is None or k % EXCHANGE_EVERY != EXCHANGE_EVERY - 1:
            return
        for req in range(2):
            res = 1 - req
            payload, found = vs[res].process_other_requests(req, vs[req].get_descriptors())
            rec["requests"] = rec.get("requests", 0) + 1
            if not found:
                continue
            rec["hits"] = rec.get("hits", 0) + 1
            slot = int(vs[req]._store.pay_head[0])
            rec["fused"] = rec.get("fused", 0) + vs[req].process_other_measurements(payload,
                                                                                   uav_id=res)
            store = vs[req]._store  # rows recorded now point at the slot just written
            rec["stored"] = rec.get("stored", 0) + int(((store.own_id >= 0)
                                                        & (store.pay_slot == slot)).sum())

    return make, frame


def run_facade(torch, params, tparams, cam, frames, imu, start, device):
    """One agent's frames (n, 1, H, W) and host IMU windows (numpy, (n, 1,
    L, ...)) through the single-agent facade (compiled), started at
    ``start`` = (p, v, q) (A, ...). Returns (the facade, applied count,
    elapsed ms)."""
    make, frame = facade_path(params, tparams, cam, frames, imu, start, device)
    vs, rec = make(), {}
    ms = _per_frame(torch, frames.shape[0], lambda k: frame(vs, k, rec))
    return vs[0], rec["applied"], ms


def descriptor_agreement(torch, img, pts, valid) -> dict:
    """The card's float32 descriptors against the CPU's float64 ones on the
    same frame and keypoints: the share of bits that agree, of keypoints
    whose 256 bits all agree, and the largest comparison margin |va - vb|
    (float64) among the bits that differ."""
    from x_multi_agent_torch.place_recognition import descriptors

    d_card, ok = descriptors.compute(img, pts, valid)
    args = (img.double().cpu(), pts.double().cpu())
    d_cpu, ok_cpu = descriptors.compute(*args, valid.cpu())
    keep = ok.cpu() & ok_cpu
    bits_card = descriptors.unpack_bits(d_card.cpu())[keep]
    bits_cpu = descriptors.unpack_bits(d_cpu)[keep]
    differ = bits_card != bits_cpu
    margin = descriptors.bit_margin(*args)[keep]
    return {
        "n_keypoints": int(keep.sum()),
        "bit_agree": 1.0 - float(differ.double().mean()),
        "keypoints_exact": float((~differ.any(-1)).double().mean()),
        "max_disagree_margin": float(margin[differ].max()) if bool(differ.any()) else 0.0,
    }


def run_request_comm(torch, params, tparams, cam, start, frames, imu, device):
    """A fleet started at ``start`` through ``frame_step`` (tracker
    descriptors on) for ``N_RC`` frames, each followed by the keyframe step,
    with a request-response round after each frame in ``RC_ROUNDS`` and a
    joint-MSCKF round at the end. Returns (fs, words, record)."""
    from x_multi_agent_torch.parallel import collab
    from x_multi_agent_torch.place_recognition import database as db_mod, descriptors
    from x_multi_agent_torch.place_recognition.vocabulary import train_kmajority
    from x_multi_agent_torch.vio import vio
    from x_multi_agent_torch.vio.frame_step import frame_step
    from x_multi_agent_torch.vision import tracker

    a, h, w = frames.shape[1:]
    ccfg = collab.CollabConfig()
    fs, slots = vio.init_at_time(params, 0.0, a, device, p=start[0], v=start[1], q=start[2])
    tstate = tracker.TrackerState.zero(tparams, a, h, w, device=device)
    db_dims = db_mod.DbDims(n_keyframes=15, n_words=N_WORDS, max_agents=a)
    times, seqs, w_ms, a_ms = imu
    n_sel = torch.zeros((a,), dtype=torch.int64, device=device)
    rec = {"rounds": []}
    for k in range(N_RC):
        tstate, fs, slots, _, applied = frame_step(
            params, tparams, cam, tstate, fs, slots, frames[k], times[k], seqs[k],
            w_ms[k], a_ms[k], times[k][:, -1], seed=2,
        )
        if k == 0:  # the vocabulary, from the fleet's frame-0 descriptors
            d0, ok0 = descriptors.compute(frames[0], tstate.pts, tstate.ids >= 0)
            pool = d0[ok0].cpu().numpy()
            words = torch.from_numpy(train_kmajority(pool, N_WORDS, seed=0).words).to(device)
            rec["vocab_from"] = int(pool.shape[0])
            db = db_mod.KeyframeDB.zero(db_dims, collab.extract_payload_desc(params, fs, slots))
            kf_meta = collab.KfMeta.zero(a, fs.cov.dtype, device)
        db, kf_meta, sel = collab.maybe_add_keyframe(params, db_dims, words, fs, slots, db,
                                                     kf_meta, enabled=applied)
        n_sel = n_sel + sel.to(torch.int64)
        if k + 1 in RC_ROUNDS:
            (fs, db, hits, n_matches), ms = _timed(torch, lambda: collab.request_response_round(
                params, ccfg, words, fs, slots, db))
            rec["rounds"].append({
                "after_frame": k + 1, "ms": ms, "hits": int(hits.sum()),
                "hits_per_requester": hits.sum(1).tolist(), "fused": int(n_matches.sum()),
                "fused_per_agent": n_matches.sum(1).tolist(), **_cov_health(torch, fs.cov),
            })
    (fs, n_msckf), ms = _timed(torch, lambda: collab.collaborative_msckf_round(
        params, ccfg, fs, slots))
    rec["msckf_round"] = {"ms": ms, "fused": int(n_msckf.sum()),
                          "fused_per_agent": n_msckf.tolist(), **_cov_health(torch, fs.cov)}
    rec["keyframes_per_agent"] = n_sel.tolist()
    rec["payload_bytes"] = collab.payload_nbytes(collab.extract_payload_desc(params, fs, slots))
    rec["vlad_bytes"] = collab.vlad_nbytes(words)
    last = (frames[N_RC - 1], tstate.pts, tstate.ids >= 0)
    rec["desc_ms"] = _ms(torch, lambda: descriptors.compute(*last))
    rec["desc_bits"] = descriptor_agreement(torch, *last)
    return fs, words, rec


def run_facade_pair(torch, params, tparams, cam, frames, imu, start, words, device):
    """Agents 0 and 1 (frames (n, 2, H, W), host IMU windows (n, 2, L, ...))
    through two collaborating facades (compiled), an exchange every
    ``EXCHANGE_EVERY`` frames. Returns (facades, record)."""
    from x_multi_agent_torch.parallel import collab

    make, frame = facade_path(params, tparams, cam, frames, imu, start, device, words=words)
    vs = make()
    payload_b = collab.payload_nbytes(vs[0].get_data_to_send())
    vlad_b = collab.vlad_nbytes(words)
    rec = {"applied": 0, "hits": 0, "fused": 0, "stored": 0, "requests": 0}
    rec["ms"] = _per_frame(torch, frames.shape[0], lambda k: frame(vs, k, rec))
    rec["bytes_full"] = 2 * payload_b * frames.shape[0]  # full broadcast: every frame, both ways
    rec["bytes_rr"] = rec["requests"] * vlad_b + rec["hits"] * payload_b
    rec["keyframes"] = [v.n_keyframes_selected for v in vs]
    rec["consumed"] = [int(v.n_collab_consumed) for v in vs]
    rec["reinits"] = [v.n_reinits for v in vs]
    rec["payload_bytes"], rec["vlad_bytes"] = payload_b, vlad_b
    return vs, rec


def thermal_photometric(spatial: bool) -> dict:
    """Phase 9's ``enable_photometric`` keywords (global only, or with the
    spatial map)."""
    return dict(n_obs=PHOTO_OBS, spatial=spatial, cell_px=CELL_PX, spatial_every=SPATIAL_EVERY,
                seed=5)


def run_thermal(torch, params, tparams, cam, raw, clean, imu, start, spatial, device):
    """Degraded frames ``raw`` (n, 1, H, W) uint8 and host IMU windows
    (numpy, (n, 1, L, ...)) through one facade (compiled) with photometric
    calibration (``spatial`` or global only). Returns (the facade,
    record)."""
    import warnings

    from x_multi_agent_torch.photometric import calib
    from x_multi_agent_torch.utils.bench import trace_calls

    make, frame = facade_path(params, tparams, cam, raw, imu, start, device,
                              photometric=thermal_photometric(spatial))
    vs, rec = make(), {}
    v = vs[0]
    update = v._photometric_update
    upd_events, gains_before, gains_after = [], [], []

    def timed_update(raw_img):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        update(raw_img)
        ev[1].record()
        upd_events.append(ev)

    v._photometric_update = timed_update

    def run(k):
        gains_before.append(v.photo.state.current())
        frame(vs, k, rec)
        gains_after.append(v.photo.state.current())

    ms = _per_frame(torch, raw.shape[0], run)
    v._photometric_update = update
    n = raw.shape[0]
    rec.update({"ms": ms, "reinits": v.n_reinits,
                "update_ms": sum(s.elapsed_time(e) for s, e in upd_events) / n,
                "gains": torch.stack(gains_after).double().cpu(),
                "solved": v.photo.ps is not None and bool((v.photo.ps != 0).any())})
    g = torch.stack(gains_before)  # the gains each frame was corrected with
    tail = range(n - 10, n)
    rec["err_corrected"] = float(torch.stack([
        (calib.correct_image(raw[k, 0], g[k, 0], g[k, 1]).double() - clean[k].double()).abs().mean()
        for k in tail]).mean())
    rec["err_raw"] = float(torch.stack([(raw[k, 0].double() - clean[k].double()).abs().mean()
                                        for k in tail]).mean())
    if v.photo.ps is not None:
        rec["map_finite"] = bool(torch.isfinite(v.photo.ps).all())
        rec["map_range"] = [float(v.photo.ps.min()), float(v.photo.ps.max())]

    # 10 further updates on the last frame: the synchronizing operations of
    # each (warnings of the sync debug mode); then 10 under the profiler:
    # launch calls and graph launches per update, the photometric programs'
    # device-busy ms and the idle share of an update
    syncs, last = [], raw[-1, 0].to(params.tdtype)  # the raw frame as the update sees it
    for _ in range(10):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                due = (v.photo.frame + 1) % SPATIAL_EVERY == 0 and spatial
                update(last)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs.append((due, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                            if "called a synchronizing" in str(w.message)]))
    rec["syncs"] = syncs
    graphs = [p.graphs for p in v.programs if p.name in ("VIO.photo_frame", "VIO.spatial_solve")]
    rec["update_trace"] = trace_calls(lambda i: update(last), 10, device, graphs)
    return v, rec


class _PhotoInputs:
    """Keeps the inputs of the last ``calib.process_frame`` and the inputs
    and output of the last spatial solve an eager facade ran (a compiled
    one calls them only while capturing)."""

    def __enter__(self):
        from x_multi_agent_torch.photometric import calib

        self.calib, self.last = calib, {}
        self.dispatch = calib.process_frame, calib.estimate_spatial_parameters
        frame_fn, solve_fn = self.dispatch

        def keep_frame(*args, **kwargs):
            self.last["frame"] = (args, kwargs)
            return frame_fn(*args, **kwargs)

        def keep_solve(*args, **kwargs):
            out = solve_fn(*args, **kwargs)
            self.last["solve"] = (args, kwargs, out)
            return out

        calib.process_frame, calib.estimate_spatial_parameters = keep_frame, keep_solve
        return self

    def __exit__(self, *exc):
        self.calib.process_frame, self.calib.estimate_spatial_parameters = self.dispatch


def _components(n: int, sid_hist, sid_cur, valid, seen):
    """The connected components of the seen cells under the valid rows'
    (sid_hist, sid_cur) edges: a list of (n,) float64 indicator vectors."""
    import numpy as np

    parent = list(range(n))

    def root(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    v = valid.cpu().numpy()
    for i, j in zip(sid_hist.cpu().numpy()[v], sid_cur.cpu().numpy()[v]):
        parent[root(int(i))] = root(int(j))
    seen = seen.cpu().numpy()
    roots = sorted({root(i) for i in range(n) if seen[i]})
    return [np.array([float(seen[i] and root(i) == r) for i in range(n)]) for r in roots]


def photo_card_vs_cpu(torch, last) -> dict:
    """The thermal facade's last ``process_frame`` and last spatial solve
    (run B's eager twin in phase 15, whose every leaf equals the compiled
    run's after every frame: ``_PhotoInputs``), re-run on the card and
    through the port on the CPU in float64 on the card's inputs: |da|,
    |db|; the
    largest difference of the centred maps and the maps' mean offset (card
    minus CPU); and the largest difference left once each connected
    component of the seen cells takes its own offset (the Laplacian's null
    directions, fixed only by its 1e-6 term; the smoothing spreads a
    component's offset unevenly, so centring does not remove it), with
    those offsets fitted by least squares."""
    from x_multi_agent_torch.photometric import calib
    from x_multi_agent_torch.utils.tree import map_leaves

    def cpu64(x):
        x = x.cpu()
        return x.double() if x.is_floating_point() else x

    args, kwargs = last["frame"]
    card = calib.process_frame(*args, **kwargs)
    cpu = calib.process_frame(*[map_leaves(cpu64, a) for a in args], **kwargs)
    out = {"da": abs(float(card[1]) - float(cpu[1])), "db": abs(float(card[2]) - float(cpu[2]))}
    args, kwargs, cells = last["solve"]
    ncx, ncy, sid_hist, sid_cur, rhs, valid = args
    ref = calib.estimate_spatial_parameters(*[map_leaves(cpu64, a) for a in args], **kwargs)
    got = cells.double().cpu()
    out["map_offset"] = float(got.mean() - ref.mean())
    out["map_centred_err"] = float(((got - got.mean()) - (ref - ref.mean())).abs().max())
    out["map_scale"] = float((ref - ref.mean()).abs().max())
    n = ncx * ncy
    _, seen = calib.solve_cell_offsets(n, sid_hist.cpu(), sid_cur.cpu(), cpu64(rhs), valid.cpu())
    comps = _components(n, sid_hist, sid_cur, valid, seen)
    basis = torch.stack([calib.gpr_smooth(torch.from_numpy(c), seen, ncx, ncy, **kwargs).reshape(-1)
                         for c in comps], 1)
    diff = (got - ref).reshape(-1, 1)
    offsets = torch.linalg.lstsq(basis, diff).solution
    out["components"] = [int(c.sum()) for c in comps]
    out["component_offsets"] = offsets[:, 0].tolist()
    out["map_err_per_component"] = float((diff - basis @ offsets).abs().max())
    return out


def exchange_rank(mesh, n_agents, words):
    """Phase 10a's rank, in a process of its own (``mesh.spawn_agents``):
    this rank's block of phase 7's fleet (a fresh fleet from
    ``orbit_start``, rendered here) through ``frame_step.CompiledFrameStep``
    with descriptors for ``N_RC`` frames (K1/K2 launched from the tracker's
    graphs and counted from their nodes), the keyframe step after each
    (eager, as in the reference), then :func:`round_twins` from the state
    after the last frame. Returns the block's pre-round states, the compiled
    twin's first round outputs, the twins' record, K1/K2 launches (and
    whether every graph's were read from its nodes) and updates applied."""
    import torch

    _no_jax()
    from x_multi_agent_torch import configs
    from x_multi_agent_torch.parallel import collab
    from x_multi_agent_torch.place_recognition import database as db_mod
    from x_multi_agent_torch.utils import tree
    from x_multi_agent_torch.utils.scene import orbit_dataset, orbit_start
    from x_multi_agent_torch.vio import vio
    from x_multi_agent_torch.vio.frame_step import CompiledFrameStep
    from x_multi_agent_torch.vision import fast, lk, tracker

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    dev, sl = mesh.device, mesh.block(n_agents)
    blk = sl.stop - sl.start
    frames, (times, seqs, w_ms, a_ms) = orbit_dataset(n_agents, N_RC, H, W, dev, agents=sl)
    p0, v0, q0 = (x[sl] for x in orbit_start(n_agents))
    params = configs.flagship_params()
    tparams = configs.flagship_tracker(params.cfg.tracks.n_matches)._replace(
        compute_descriptors=True)
    cam = configs.flagship_camera(H, W)
    ccfg = collab.CollabConfig()
    words = words.to(dev)
    db_dims = db_mod.DbDims(n_keyframes=15, n_words=N_WORDS, max_agents=n_agents)
    fast.K1.launches = lk.K2.launches = 0
    fs, slots = vio.init_at_time(params, 0.0, blk, dev, p=p0, v=v0, q=q0)
    tstate = tracker.TrackerState.zero(tparams, blk, H, W, device=dev)
    db = db_mod.KeyframeDB.zero(db_dims, collab.extract_payload_desc(params, fs, slots))
    kf_meta = collab.KfMeta.zero(blk, fs.cov.dtype, dev)
    n_applied = torch.zeros((), dtype=torch.int64, device=dev)
    step = CompiledFrameStep(params, tparams, cam, seed=2)
    for k in range(N_RC):
        tstate, fs, slots, _, applied = step(tstate, fs, slots, frames[k], times[k], seqs[k],
                                             w_ms[k], a_ms[k], times[k][:, -1])
        db, kf_meta, _ = collab.maybe_add_keyframe(params, db_dims, words, fs, slots, db,
                                                   kf_meta, enabled=applied)
        n_applied = n_applied + applied.sum()
    launches = {"fast": fast.K1.launches, "lk": lk.K2.launches}
    pre = tree.map_leaves(torch.clone, (fs, slots, db))  # the step's buffers, kept
    drive_s = time.perf_counter() - t0
    twins, first = round_twins(torch, mesh, params, ccfg, words, *pre)
    _no_jax()
    return {"pre": pre, **first, "twins": twins, "launches": launches,
            "kernels_read": all(g.kernels_read for g in step.graphs), "applied": int(n_applied),
            "seconds": {"drive": drive_s, "twins": time.perf_counter() - t0 - drive_s}}


def watched_call(torch, fn, traced: bool) -> tuple:
    """``fn()`` watched, for the twins of phases 10 and 15: (its result, ms
    by CUDA events around it, the synchronizing calls that the sync debug
    mode warned of, and with ``traced`` (kernel launch calls, graph
    launches) from a host-only ``torch.profiler`` trace, else None)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from x_multi_agent_torch.utils.bench import launch_calls

    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            with (profile(activities=[ProfilerActivity.CPU]) if traced
                  else contextlib.nullcontext()) as prof:
                ev[0].record()
                out = fn()
                ev[1].record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return (out, ev[0].elapsed_time(ev[1]),
            sum("called a synchronizing" in str(w.message) for w in caught),
            launch_calls(prof) if traced else None)


def round_twins(torch, mesh, params, ccfg, words, fs, slots, db) -> tuple:
    """Phase 10's twins on one rank (a gloo rank, or this process at NCCL
    world size 1), from one start (this rank's blocks): ``EXCHANGE_ROUNDS``
    rounds, each ``sharded_collab_round_desc`` then ``sharded_collab_round``
    on its result, by the compiled programs (the first call of each
    captures) and, in turns, by their plain twins (``compiled=False``), each
    twin shipping on its own copy of the mesh; after every round every leaf
    of both programs' outputs compared (:func:`tree_diff`). Per twin,
    program and round: ms (CUDA events around the call), host syncs (the
    sync debug mode's warnings), kernel launch calls outside graphs and
    graph launches (a host-only ``torch.profiler`` trace of every compiled
    call after the capture and of the plain twin's last round). Returns
    (the record, the compiled twin's first round outputs, cloned: {"desc":
    ..., "full": ...})."""
    import dataclasses

    from x_multi_agent_torch.parallel import mesh as pmesh
    from x_multi_agent_torch.utils import tree

    keys = ("desc", "full")
    twins, first = {}, None
    rec = {"rounds": EXCHANGE_ROUNDS, "bitwise_rounds": 0, "first_diff": None}
    for mode in ("compiled", "eager"):
        m = dataclasses.replace(mesh, shipped={})
        c = mode == "compiled"
        twins[mode] = {"mesh": m, "state": (fs, db),
                       "desc": pmesh.sharded_collab_round_desc(params, ccfg, words, m, compiled=c),
                       "full": pmesh.sharded_collab_round(params, ccfg, m, compiled=c)}
        rec[mode] = {key: {"ms": [], "syncs": [], "calls": []} for key in keys}
    for k in range(EXCHANGE_ROUNDS):
        outs = {}
        for mode, tw in twins.items():
            # every replay of the compiled twin, the plain twin's last round
            traced = (mode == "compiled" and k > 0) or k == EXCHANGE_ROUNDS - 1
            f, d = tw["state"]
            for key in keys:
                r = rec[mode][key]
                out, ms, syncs, calls = watched_call(
                    torch, (lambda: tw["desc"](f, slots, d)) if key == "desc"
                    else (lambda: tw["full"](f)), traced)
                r["ms"].append(ms)
                r["syncs"].append(syncs)
                r["calls"].append(calls)
                outs[mode, key] = out
                f, d = (out[0], out[1]) if key == "desc" else (out[0], d)
            tw["state"] = (f, d)
        diffs = {key: tree_diff(torch, outs["compiled", key], outs["eager", key], f"{key}[{k}]")
                 for key in keys}
        if all(x["bitwise"] for x in diffs.values()):
            rec["bitwise_rounds"] += 1
        elif rec["first_diff"] is None:
            rec["first_diff"] = diffs
        if k == 0:
            first = {key: tree.map_leaves(torch.clone, outs["compiled", key]) for key in keys}
    for mode, tw in twins.items():
        for key in keys:
            r = rec[mode][key]
            steady = r["ms"][1:] if mode == "compiled" else r["ms"]
            r["ms_steady"], r["ms_all"] = sum(steady) / len(steady), sum(r["ms"]) / len(r["ms"])
            r["syncs_per_round"] = sum(r["syncs"][-len(steady):]) / len(steady)
            calls = [c for c in r["calls"][-len(steady):] if c is not None]
            r["launch_calls"] = sum(c[0] for c in calls) / len(calls)
            r["launch_calls_max"] = max(c[0] for c in calls)
            r["graph_launches"] = sum(c[1] for c in calls) / len(calls)
            if mode == "compiled":
                g = tw[key].graphs
                r.update(captured=g.captured, capture_s=g.capture_s, pool_bytes=g.pool_bytes)
        rec[mode]["shipped"] = dict(tw["mesh"].shipped)
    return rec, first


def tree_diff(torch, got, ref, path="out") -> dict:
    """Leaf by leaf (``utils.tree.leaves`` order): the integer and boolean
    leaves that differ, the worst float difference as a share of its leaf's
    max |ref| (and where), and whether every leaf is bit-identical. A leaf
    is named ``path[i]`` by its index."""
    from x_multi_agent_torch.utils import tree

    got, ref = tree.leaves(got), tree.leaves(ref)
    if len(got) != len(ref):
        raise AssertionError(f"{path}: {len(got)} leaves != {len(ref)}")
    out = {"int_differ": [], "worst_rel": 0.0, "worst_at": None, "bitwise": True}
    for i, (g, r) in enumerate(zip(got, ref)):
        p = f"{path}[{i}]"
        if not isinstance(g, torch.Tensor):
            if g != r:
                out["bitwise"] = False
                out["int_differ"].append(p)
            continue
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{p}: {g.dtype}{tuple(g.shape)} != {r.dtype}{tuple(r.shape)}")
        same = torch.equal(g.reshape(-1).contiguous().view(torch.uint8),
                           r.reshape(-1).contiguous().view(torch.uint8))
        out["bitwise"] = out["bitwise"] and same
        if same:
            continue
        if not g.is_floating_point():
            out["int_differ"].append(p)
            continue
        err = float((g.double() - r.double()).abs().max())
        scale = float(r.abs().max())
        rel = err / scale if scale > 0 else float("inf")
        if not rel <= out["worst_rel"]:  # NaN counts as the worst
            out["worst_rel"], out["worst_at"] = rel, p
    return out


def run_exchange(torch, params, words, device) -> dict:
    """Phase 10: the multi-rank exchange on the card. 10a: ``N_RANKS``
    gloo ranks on the one card run phase 7's fleet in blocks and the round
    twins (:func:`exchange_rank`); the single-process rounds on their
    gathered pre-round states, with the same keyed draws, are held against
    the compiled twins' first rounds; 10b: the twins in this process at
    NCCL world size 1 on the gathered states (:func:`round_twins`), the
    compiled first rounds bit for bit the single-process rounds; 10c: the
    dry run on ``N_RANKS`` gloo ranks of 2 agents. Returns the record."""
    import shutil
    import tempfile

    from x_multi_agent_torch.parallel import collab, dryrun, mesh as pmesh
    from x_multi_agent_torch.utils import tree

    t0 = time.perf_counter()
    ccfg = collab.CollabConfig()
    tmp = tempfile.mkdtemp(prefix="smoke_exchange_")
    try:
        ranks = pmesh.spawn_agents(exchange_rank, N_RANKS, "gloo", f"file://{tmp}/gloo",
                                   (N_AGENTS, words.cpu()), timeout_s=300.0)
        rec = {"ranks_s": time.perf_counter() - t0, "ranks": [
            {k: r[k] for k in ("launches", "kernels_read", "applied", "twins", "seconds")}
            for r in ranks]}

        def gathered(key):
            return tree.map_leaves(lambda x: x.to(device), tree.cat([r[key] for r in ranks]))

        fs, slots, db = gathered("pre")
        ref, rec["single_ms"] = _timed(torch, lambda: dryrun.single_rounds(
            params, fs, ccfg, ccfg, words, slots, db))
        got = {key: gathered(key) for key in ("desc", "full")}
        rec["gloo"] = {key: tree_diff(torch, got[key], ref[key], key) for key in got}
        rec["hits"] = int(got["desc"][2].sum())
        rec["desc_fused"] = int(got["desc"][3].sum())
        rec["full_fused"] = int(got["full"][1].sum())
        rec["finite"] = all(bool(torch.isfinite(x.cov).all())
                            for x in (fs, got["desc"][0], got["full"][0]))

        t1 = time.perf_counter()
        mesh = pmesh.make_agent_mesh("nccl", f"file://{tmp}/nccl", 0, 1, device)
        try:
            rec["nccl_twins"], nccl = round_twins(torch, mesh, params, ccfg, words, fs, slots, db)
            torch.cuda.synchronize()
        finally:
            torch.distributed.destroy_process_group()
        rec["nccl"] = {key: tree_diff(torch, nccl[key], ref[key], key) for key in nccl}
        rec["nccl_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t1 = time.perf_counter()
    rec["dryrun"] = dryrun.dryrun_multichip(N_RANKS, "gloo", 2, device="cuda")
    rec["dryrun_s"] = time.perf_counter() - t1
    rec["seconds"] = time.perf_counter() - t0
    return rec


def print_round_twins(label: str, tw: dict, card) -> None:
    """Phase 10's lines for one rank's :func:`round_twins` record."""
    for key, name in (("desc", "descriptor round"), ("full", "full-map round")):
        c, e = tw["compiled"][key], tw["eager"][key]
        print(f"phase 10 {label} {name}: ms per round compiled {c['ms_steady']:.3f} over the "
              f"{tw['rounds'] - 1} replays ({c['ms_all']:.3f} over all {tw['rounds']} rounds), "
              f"eager {e['ms_steady']:.3f} (eager / compiled "
              f"{e['ms_steady'] / c['ms_steady']:.2f}); kernel launch calls outside graphs per "
              f"round compiled {c['launch_calls']:.1f} (at most {c['launch_calls_max']}), eager "
              f"{e['launch_calls']:.1f} (its last round); graph launches per round "
              f"{c['graph_launches']:.1f}; host syncs per round compiled "
              f"{c['syncs_per_round']:.2f}, eager {e['syncs_per_round']:.2f}; {c['captured']} "
              f"graphs captured in {c['capture_s']:.3f} s, pool {c['pool_bytes']} bytes ({card})")
    print(f"phase 10 {label}: bit for bit after {tw['bitwise_rounds']} of {tw['rounds']} rounds "
          f"(first difference {json.dumps(tw['first_diff'])}); bytes shipped compiled "
          f"{tw['compiled']['shipped']}, eager {tw['eager']['shipped']}")


def check_round_twins(label: str, tw: dict, backend: str) -> None:
    """Phase 10's checks on one :func:`round_twins` record: every round bit
    for bit, the twins' bytes equal; per compiled round (after its capture)
    one graph launch with NCCL, no host sync and fewer than 10 kernel
    launch calls outside it; with gloo a graph per segment (full-map 2,
    descriptor 3)."""
    head = f"phase 10 {label}"
    if tw["bitwise_rounds"] != tw["rounds"]:
        raise AssertionError(f"{head}: compiled differs from eager: {tw['first_diff']}")
    if tw["compiled"]["shipped"] != tw["eager"]["shipped"]:
        raise AssertionError(f"{head}: the twins shipped {tw['compiled']['shipped']} and "
                             f"{tw['eager']['shipped']}")
    for key, segments in (("desc", 3), ("full", 2)):
        c = tw["compiled"][key]
        want = 1 if backend == "nccl" else segments
        if c["graph_launches"] != want:
            raise AssertionError(f"{head} {key}: {c['graph_launches']} graph launches per round, "
                                 f"not {want}")
        if backend == "nccl" and (c["syncs_per_round"] != 0 or c["launch_calls_max"] >= 10):
            raise AssertionError(f"{head} {key}: {c['syncs_per_round']} host syncs, "
                                 f"{c['launch_calls_max']} launch calls outside graphs per round")


def check_exchange(ex, counts, card) -> None:
    """Phase 10's prints and checks on the record of :func:`run_exchange`;
    the ranks' K1/K2 launches add to ``counts``' totals."""
    for i, r in enumerate(ex["ranks"]):
        for name in counts.total:
            counts.total[name] += r["launches"][name]
        print(f"exchange rank {i}: {N_AGENTS // N_RANKS} agents x {N_RC} frames through "
              f"CompiledFrameStep, updates applied {r['applied']}/{N_AGENTS // N_RANKS * N_RC}; "
              f"launches K1 {r['launches']['fast']} K2 {r['launches']['lk']} (read from the "
              f"graphs' kernel nodes: {r['kernels_read']}); {r['seconds']['drive']:.2f} s to render "
              f"and drive the frames, {r['seconds']['twins']:.2f} s for the twins ({card})")
        print_round_twins(f"gloo rank {i}", r["twins"], card)
    print_round_twins("NCCL world size 1", ex["nccl_twins"], card)
    print(f"exchange: {N_RANKS} gloo ranks on one card, {ex['ranks_s']:.2f} s for the ranks; "
          f"hits {ex['hits']}, matches fused {ex['desc_fused']} (descriptor round) and "
          f"{ex['full_fused']} (full-map round); single-process rounds {ex['single_ms']:.3f} ms; "
          f"compiled first rounds against them: gloo {json.dumps(ex['gloo'])}; NCCL world size 1 "
          f"{json.dumps(ex['nccl'])} ({card})")
    dry = ex["dryrun"]
    print(f"exchange dry run: {dry['agents']} agents on {dry['ranks']} gloo ranks: fused "
          f"{dry['matches_fused']} + {dry['desc_fused']}, hits {dry['hits']}, bytes gated "
          f"{dry['bytes_gated']} vs full {dry['bytes_full']}, shipped {dry['shipped']}, checks "
          f"{dry['checks']} ({card})")
    print(f"phase 10: {ex['seconds']:.2f} s wall: the ranks {ex['ranks_s']:.2f} s, NCCL "
          f"{ex['nccl_s']:.2f} s, the dry run {ex['dryrun_s']:.2f} s ({card})")
    applied = sum(r["applied"] for r in ex["ranks"])
    if applied < 0.9 * N_AGENTS * N_RC or not ex["finite"]:
        raise AssertionError(f"exchange: {applied} updates applied, covariance finite {ex['finite']}")
    if any(r["launches"]["fast"] < 1 or r["launches"]["lk"] < 3 * N_RC or not r["kernels_read"]
           for r in ex["ranks"]):
        raise AssertionError(f"exchange: a rank missed a kernel: {ex['ranks']}")
    if ex["hits"] < 1 or ex["desc_fused"] < 1 or ex["full_fused"] < 1:
        raise AssertionError("exchange: no hit or no fused match")
    for key, d in ex["gloo"].items():
        if d["int_differ"] or not d["worst_rel"] <= 1e-4:
            raise AssertionError(f"exchange: the {key} round on the ranks differs: {d}")
    for key, d in ex["nccl"].items():
        if not d["bitwise"]:
            raise AssertionError(f"exchange: the {key} round at NCCL world size 1 differs: {d}")
    for i, r in enumerate(ex["ranks"]):
        check_round_twins(f"gloo rank {i}", r["twins"], "gloo")
    check_round_twins("NCCL world size 1", ex["nccl_twins"], "nccl")


def run_ate_report(torch, dev) -> dict:
    """Phase 11: ``ate_report.run_report`` with the CLI's defaults, ``--vocab
    random`` and ``ATE_DURATION`` s, in a fresh dataset directory, with its
    facades, replays and exchange rounds watched: K1's shapes, K2's
    launches per agent-frame, the (responder, requester) pairs of each
    round, CUDA events around each replay (from its first IMU batch) and
    each round, and the last K1 and K2 inputs (``_KernelInputs``, replayed
    after the phase). Returns the record."""
    import glob
    import shutil
    import tempfile

    import numpy as np

    from x_multi_agent_torch.parallel import collab
    from x_multi_agent_torch.utils import ate_report as ar
    from x_multi_agent_torch.vision import fast, lk

    t0 = time.perf_counter()
    args = ar.parse_args(["--vocab", "random", "--duration", str(ATE_DURATION)])
    rec = {"k2": {}, "rounds": [], "passes": [], "facades": []}
    build, replay, exchange = ar.build_agent, ar.replay, ar._exchange_round
    k_in = _KernelInputs(fast, lk, keep=-1)

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def watched_agent(meta, degraded, words, ccfg, uav_id, collab, *a, **kw):
        v = k_in.watching(build(meta, degraded, words, ccfg, uav_id, collab, *a, **kw))
        rec["facades"].append(weakref.ref(v))  # phase 12's check: dropped, they free their graphs
        k2 = rec["k2"].setdefault((collab, uav_id), [])
        imu, image, requests = v.process_imu_batch, v.process_image_measurement, \
            getattr(v, "process_other_requests", None)

        def process_imu_batch(*p):
            if rec["passes"][-1]["start"] is None:
                rec["passes"][-1]["start"] = event()
            return imu(*p)

        def process_image_measurement(*p, **k):
            n0 = lk.K2.launches
            out = image(*p, **k)
            k2.append(lk.K2.launches - n0)
            return out

        def process_other_requests(requester_id, vlad):
            rec["rounds"][-1]["pairs"].append((uav_id, requester_id))
            return requests(requester_id, vlad)

        v.process_imu_batch, v.process_image_measurement = process_imu_batch, process_image_measurement
        if collab:
            v.process_other_requests = process_other_requests
        return v

    def timed_replay(agents, *a, **kw):
        rec["passes"].append({"agents": len(agents), "start": None})
        out = replay(agents, *a, **kw)
        rec["passes"][-1]["end"] = event()
        return out

    def timed_round(agents, pb, vb):
        rec["rounds"].append({"pairs": [], "start": event()})
        out = exchange(agents, pb, vb)
        rec["rounds"][-1]["end"] = event()
        return out

    root, tmp = ar.DATASET_ROOT, tempfile.mkdtemp(prefix="smoke_ate_")
    ar.DATASET_ROOT = tmp
    ar.build_agent, ar.replay, ar._exchange_round = watched_agent, timed_replay, timed_round
    k_in.__enter__()
    try:
        rep, agents = ar.run_report(args, device=dev)
        torch.cuda.synchronize()
        rec["report"], rec["args"] = rep, args
        rec["fast_threshold"] = agents[0]._tracker_params.fast_threshold
        rec["payload_bytes"] = collab.payload_nbytes(agents[0].get_data_to_send())
        solo_files = sorted(glob.glob(os.path.join(tmp, "solo_a*.json")))
        rec["solo"] = [json.load(open(f)) for f in solo_files]
        traces = [os.path.join(tmp, f"trace_solo_a{a}.npz") for a in range(args.agents)]
        traces.append(os.path.join(tmp, "trace_collab.npz"))
        rec["finite"] = all(bool(np.isfinite(np.load(f)["est"]).all()) for f in traces)
    finally:
        ar.DATASET_ROOT = root
        ar.build_agent, ar.replay, ar._exchange_round = build, replay, exchange
        k_in.__exit__()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["k_in"], rec["k1_shapes"] = k_in, set(k_in.k1)  # every shape K1 was launched on
    for p in rec["passes"]:
        p["ms"] = p["start"].elapsed_time(p["end"])
    for r in rec["rounds"]:
        r["ms"] = r["start"].elapsed_time(r["end"])
    rec["seconds"] = time.perf_counter() - t0
    return rec


def check_ate_report(ate, launches, card) -> None:
    """Phase 11's prints and asserts on the record of :func:`run_ate_report`
    and the K1/K2 launches read around it."""
    rep, args = ate["report"], ate["args"]
    pa, na = rep["per_agent"], args.agents
    n_frames = len(ate["k2"][(False, 0)])
    solo_ms = sum(p["ms"] for p in ate["passes"][:na]) / (na * n_frames)
    round_ms = [r["ms"] for r in ate["rounds"]]
    collab_ms = (ate["passes"][na]["ms"] - sum(round_ms)) / (na * n_frames)
    solo_reinits = [s["n_reinits"][0] for s in ate["solo"]]
    print(f"ate report: {na} agents x {n_frames} frames at {args.height}x{args.width}, agent "
          f"{args.degraded} degraded, vocabulary {args.vocab}; aligned ATE solo {pa['ate_solo_m']} "
          f"collab {pa['ate_collab_m']} m; mean NEES solo {pa['mean_nees_solo']} collab "
          f"{pa['mean_nees_collab']}; re-inits solo {solo_reinits} collab {pa['n_reinits']}; "
          f"fused {pa['rr_fused']} ({card})")
    rc = rep["request_comm"]
    print(f"ate report: {len(round_ms)} exchange rounds, hits {rc['hits']}, bytes "
          f"{rc['bytes_request_response']} vs full broadcast {rc['bytes_full_broadcast']} "
          f"(reduction {rc['bandwidth_reduction_pct']} %), keyframes {rep['keyframes_selected']}; "
          f"degraded agent {json.dumps(rep['degraded_agent'])}; gates (printed, not asserted) "
          f"{json.dumps(rep['gates'])} ({card})")
    print(f"ate report: {solo_ms:.3f} ms per agent-frame solo, {collab_ms:.3f} ms per "
          f"agent-frame collaborative (exchange rounds taken out), exchange rounds "
          f"{[round(x, 3) for x in round_ms]} ms; K1 shapes {sorted(ate['k1_shapes'])}; "
          f"launches K1 {launches['fast']} K2 {launches['lk']}; phase 11: {ate['seconds']:.2f} s "
          f"wall (budget {ATE_BUDGET_S:.0f} s) ({card})")
    k2_short = {key: [i for i, n in enumerate(ks) if i and n < 3] for key, ks in ate["k2"].items()}
    after_10 = n_frames - 11
    if not ate["finite"]:
        raise AssertionError("ate report: a position is not finite")
    if any(solo_reinits) or any(pa["n_reinits"]):
        raise AssertionError(f"ate report: re-inits solo {solo_reinits} collab {pa['n_reinits']}")
    if not rep["gates"]["helpers_converged_collab"]:
        raise AssertionError(f"ate report: a helper's collaborative ATE >= 1 m: {pa['ate_collab_m']}")
    pairs = sorted((res, req) for res in range(na) for req in range(na) if res != req)
    every = args.exchange_every
    n_rounds = sum(1 for f in range(11, n_frames) if f % every == every - 1)
    if len(ate["rounds"]) != n_rounds or any(sorted(r["pairs"]) != pairs for r in ate["rounds"]):
        raise AssertionError(f"ate report: a round missed a pair: {[r['pairs'] for r in ate['rounds']]}")
    if rc["bytes_full_broadcast"] != ate["payload_bytes"] * len(pairs) * after_10:
        raise AssertionError(f"ate report: full broadcast {rc['bytes_full_broadcast']} != "
                             f"{ate['payload_bytes']} x {len(pairs)} x {after_10}")
    if ((1, args.height, args.width) not in ate["k1_shapes"] or any(k2_short.values())
            or launches["fast"] < 1):
        raise AssertionError(f"ate report missed a kernel: {launches}, {ate['k1_shapes']}, {k2_short}")
    if ate["seconds"] > ATE_BUDGET_S:  # reported, not failed: the shared host sets the pace
        for out in (sys.stdout, sys.stderr):
            print(f"ate report: OVER its {ATE_BUDGET_S:.0f} s budget ({ate['seconds']:.2f} s): "
                  "shorten ATE_DURATION", file=out)


def hold_kernels(torch, fast, lk, k1_in, k2_in, thr, where, card, timed=True,
                 stable_floor=None) -> float:
    """K1 on the images ``k1_in`` and K2 on the levels ``k2_in`` that a
    path gave them: against their plain versions (K1 exact; K2
    under phase 2's gate, :func:`k2_agrees`), both free of NaN, then (with
    ``timed``) per launch as in phase 4. With ``stable_floor`` K2's flows
    are compared only where ``lk.flow_sensitivity`` finds them fixed by
    their inputs at float32 resolution (a 1e-5 px move of the point moves
    the float64 flow by at most 1e-3 px; ROADMAP C5, the rule of the
    kernels' edge-band tests), and at least that share of the flows both
    track must be compared; the ``ok`` flags everywhere. Returns K2's
    largest flow difference."""
    for img in k1_in:
        got = fast.fast_score_nms(img, thr)
        err = float((got - fast.nms3(fast.fast_score(img, thr))).abs().max())
        print(f"K1 at {where} {tuple(img.shape)}: max |kernel - plain| = {err}, corners "
              f"{int((got > 0).sum())}")
        if err != 0.0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 differs from its plain version at {where}")
    k2_err = 0.0
    for args in k2_in:
        f_k, ok_k = lk.track_level(*args)
        f_p, ok_p = lk._track_level(*args)
        margin = lk.gate_margin(*args[2:5], args[6], args[8])
        stable, note, share = None, "", 1.0
        if stable_floor is not None:
            sens = lk.flow_sensitivity(*args)[1]
            stable = sens <= 1e-3
            err = torch.linalg.norm(f_p - f_k, dim=-1)
            both = ok_p & ok_k
            share = int((both & stable).sum()) / max(int(both.sum()), 1)
            worst = int(torch.argmax(torch.where(both, err, -1.0)))
            note = (f" (flows compared where stable: {int((both & stable).sum())} of "
                    f"{int(both.sum())}, share {share:.4f}, floor {stable_floor}; the largest "
                    f"difference anywhere {float(err.flatten()[worst]):.4g} px, its "
                    f"sensitivity {float(sens.flatten()[worst]):.4g} px)")
        stt = lk.level_agreement(f_p, ok_p, f_k, ok_k, margin, compare=stable)
        print(f"K2 at {where} level {tuple(args[0].shape)}, {args[4].shape[1]} points: "
              f"{json.dumps(stt)}{note}")
        if stt["n_both_ok"] == 0 and stt["ok_agree"] == 1.0:
            pass  # nothing to track (a black frame): the flags agree, no flow to compare
        elif not k2_agrees(stt) or (stable_floor is not None and share < stable_floor):
            raise AssertionError(f"K2 differs from its plain version at {where}")
        if not bool(torch.isfinite(f_k[ok_k]).all()):
            raise AssertionError(f"K2 gave a non-finite flow at {where}")
        k2_err = max(k2_err, stt["max_flow_err"])
    if timed:
        for name, r in kernel_times(torch, fast, lk, k1_in, k2_in, thr).items():
            print(f"time {name} per launch at {where} ({[tuple(x.shape) for x in k1_in]} "
                  f"for K1, {[tuple(a[4].shape) for a in k2_in]} points for K2): device "
                  f"{r['device_ms']:.4f} ms (CUDA graph), profiler {_profiled(r)}, events "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}), share of bound {r['share_of_bound']:.3f} ({card})")
    return k2_err


def ate_kernels(torch, fast, lk, ate, card) -> float:
    """K1 and K2 on the last inputs phase 11's path gave them (A = 1; its
    compiled facades' last frames replayed eagerly, ``_KernelInputs``)
    (:func:`hold_kernels`)."""
    k_in = ate["k_in"].replay()
    det_a1 = [k_in.k1[shape] for shape in sorted(k_in.k1, reverse=True)]
    return hold_kernels(torch, fast, lk, det_a1, k_in.k2, ate["fast_threshold"],
                        "the ATE report's", card)


class _KernelInputs:
    """Keeps the inputs K1 and K2 were launched on: K1's last images per
    shape, K2's last three levels, and both for the frame ``keep`` of the
    facade being fed (``frame``). An eager path's launches are watched as
    they happen. A compiled facade launches them from graphs, whose Python
    does not run on a replay: :meth:`watching` keeps, per frame, the
    tracker's state before it and the image it was given, and
    :meth:`replay` runs the last frame that detected, the last frame and
    the frame ``keep`` again through the eager tracker under the watch,
    which launches the kernels on the inputs the graphs gave them (phase 15
    holds each compiled facade to its eager twin bit for bit)."""

    def __init__(self, fast, lk, keep):
        self.fast, self.lk, self.keep = fast, lk, keep
        self.dispatch = fast.fast_score_nms, lk.track_level
        self.frame, self.k1, self.k2, self.k1_keep, self.k2_keep = None, {}, [], {}, []
        self.k1_called, self.frames = False, {}  # "detect", "last", "keep" -> (facade, tracker state, photometric, image)

    def __enter__(self):
        fast_dispatch, lk_dispatch = self.dispatch

        def watch_fast(imgs, *a, **kw):
            self.k1[tuple(imgs.shape)] = imgs
            self.k1_called = True
            if self.frame == self.keep:
                self.k1_keep[tuple(imgs.shape)] = imgs
            return fast_dispatch(imgs, *a, **kw)

        def watch_lk(*a):
            self.k2 = (self.k2 + [a])[-3:]
            if self.frame == self.keep:
                self.k2_keep.append(a)
            return lk_dispatch(*a)

        self.fast.fast_score_nms, self.lk.track_level = watch_fast, watch_lk
        return self

    def __exit__(self, *exc):
        self.fast.fast_score_nms, self.lk.track_level = self.dispatch

    def watching(self, v):
        """Facade ``v`` with its frame index, and per frame its tracker state
        before the frame and the inputs of the image the tracker saw, kept
        here."""
        import torch

        from x_multi_agent_torch.utils.tree import map_leaves

        inner = v.process_image_measurement

        def process_image_measurement(t, seq, img, *a, **kw):
            self.frame = seq
            photo = None if v.photo is None else (map_leaves(torch.clone, v.photo.state),
                                                  map_leaves(torch.clone, v.photo.ps))
            kept = (v, map_leaves(torch.clone, v._tracker_state), photo, img)
            n_k1, self.k1_called = self.fast.K1.launches, False
            out = inner(t, seq, img, *a, **kw)
            self.frames["last"] = kept
            if self.fast.K1.launches > n_k1 or self.k1_called:  # a graph's or an eager call
                self.frames["detect"] = kept
            if seq == self.keep:
                self.frames["keep"] = kept
            return out

        v.process_image_measurement = process_image_measurement
        return v

    def replay(self):
        """The kept frames of :meth:`watching` again through the eager
        tracker under the watch: afterwards ``k1`` holds the last detecting
        frame's images, ``k2`` the last frame's levels, ``k1_keep`` and
        ``k2_keep`` the frame ``keep``'s. Returns self."""
        import numpy as np
        import torch

        from x_multi_agent_torch.vio.vio import photo_correct
        from x_multi_agent_torch.vision import tracker

        if "keep" in self.frames:
            self.k1_keep, self.k2_keep = {}, []
        with self:
            for key in ("keep", "detect", "last"):  # the keep frame's also land in k1, k2
                if key not in self.frames:
                    continue
                v, state, photo, img = self.frames[key]
                self.frame = self.keep if key == "keep" else None
                img = (img.to(v.device) if isinstance(img, torch.Tensor)
                       else torch.from_numpy(np.ascontiguousarray(img)).to(v.device))
                dt = v.params.tdtype
                seen = img.to(dt) if photo is None else photo_correct(*photo, img, dt)[1]
                tracker.track_frame(v._tracker_params, v._camera, state, seen, seed=v._seed)
        self.frames = {}  # the facades may go
        return self


def run_studies(torch, dev, h=H, w=W) -> dict:
    """Phase 12: the ATE-report studies at 480x640 in a fresh dataset
    directory: harsh recovery (preset harsh, the cheap IMU, the camera
    black over ``STUDY_OUTAGE``) with the monitor off and on, the
    photometric ablation's three modes, the gate bisect, all at ``h`` x
    ``w``; the kernels' inputs of the harsh pass with the monitor on (its
    last frame, and the black frame ``STUDY_BLACK_FRAME``). Returns the
    record."""
    import shutil
    import tempfile

    from x_multi_agent_torch.utils import ate_report as ar
    from x_multi_agent_torch.utils import debug_collab_gates, harsh_recovery, photometric_ablation
    from x_multi_agent_torch.vision import fast, lk

    t0 = time.perf_counter()
    rec = {"harsh": {}, "facades": []}
    root, tmp = ar.DATASET_ROOT, tempfile.mkdtemp(prefix="smoke_studies_")
    ar.DATASET_ROOT = tmp
    build = ar.build_agent

    def tracked(*a, **kw):  # every facade of the phase, to check that dropped ones free their graphs
        v = build(*a, **kw)
        rec["facades"].append(weakref.ref(v))
        return v

    ar.build_agent = tracked
    try:
        meta = harsh_recovery.ensure_harsh_dataset(0, STUDY_DURATION, "harsh", cheap_imu=True,
                                                   h=h, w=w, device=dev)
        n_frames = int(STUDY_DURATION * 10)
        for health in (False, True):
            with _KernelInputs(fast, lk, STUDY_BLACK_FRAME) as k_in:
                ar.build_agent = lambda *a, **kw: k_in.watching(tracked(*a, **kw))
                try:
                    t1 = time.perf_counter()
                    rec["harsh"][health] = harsh_recovery.run(
                        meta, 0, health, n_frames, cheap_imu=True, outage=STUDY_OUTAGE, device=dev)
                    rec["harsh"][health]["seconds"] = time.perf_counter() - t1
                finally:
                    ar.build_agent = tracked
            rec["k_in"] = k_in
        rec["fast_threshold"] = ar.filter_config(meta, True)["fast_threshold"]
        t1 = time.perf_counter()
        rec["ablation"] = photometric_ablation.main(
            ["--duration", str(STUDY_ABLATION_DURATION),
             "--frames", str(int(STUDY_ABLATION_DURATION * 10))], h=h, w=w, device=dev)
        rec["ablation_seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        rec["gates"] = debug_collab_gates.run(STUDY_GATE_FRAMES, "random", STUDY_DURATION, h, w,
                                              device=dev, kf_probe=False)
        rec["gates_seconds"] = time.perf_counter() - t1
    finally:
        ar.DATASET_ROOT = root
        ar.build_agent = build
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def check_studies(st, launches, card) -> None:
    """Phase 12's prints and asserts on the record of :func:`run_studies`
    and the K1/K2 launches read around it."""
    import math

    from x_multi_agent_torch.utils.harsh_recovery import gates

    off, on = st["harsh"][False], st["harsh"][True]
    print(f"studies, harsh recovery ({STUDY_DURATION:.0f} s, the cheap IMU, the camera black over "
          f"frames {STUDY_OUTAGE[0]}-{STUDY_OUTAGE[1] - 1}): monitor off {json.dumps(off)}; "
          f"monitor on {json.dumps(on)}; gates {json.dumps(gates(on, off))} ({card})")
    ab = st["ablation"]
    print(f"studies, photometric ablation ({STUDY_ABLATION_DURATION:.0f} s, vignette 0.30): "
          f"{json.dumps({m: ab[m] for m in ('off', 'global', 'spatial')})}; verdict "
          f"{json.dumps(ab['verdict'])}; {st['ablation_seconds']:.2f} s ({card})")
    g = st["gates"]
    print(f"studies, gate bisect ({STUDY_GATE_FRAMES} frames, --vocab random): own valid "
          f"{g['own_valid']}, peer valid {g['peer_valid']}, kNN {g['n_knn']}, n_applied per variant "
          f"{json.dumps(g['variants'])}, keyframes in B {g['keyframes_b']}, hit {g['hit']}, fused "
          f"via the served keyframe {g['rr_fused']}; {st['gates_seconds']:.2f} s ({card})")
    print(f"studies: launches K1 {launches['fast']} K2 {launches['lk']}; phase 12: "
          f"{st['seconds']:.2f} s wall (budget {STUDY_BUDGET_S:.0f} s) ({card})")
    if off["n_reinits"] != 0 or on["n_reinits"] < 1:
        raise AssertionError(f"harsh recovery: re-inits {off['n_reinits']} (monitor off), "
                             f"{on['n_reinits']} (monitor on)")
    if not math.isfinite(on["ate"]):  # the RMS of the errors: finite iff every position is
        raise AssertionError(f"harsh recovery: a position is not finite with the monitor on: {on}")
    if not all(math.isfinite(ab[m]["ate"]) for m in ("off", "global", "spatial")):
        raise AssertionError(f"photometric ablation: a position is not finite: {ab}")
    if g["n_knn"] < 1:
        raise AssertionError(f"gate bisect: no kNN match: {g}")
    for name, c in g["cov"].items():
        if not (c["finite"] and c["max_asym"] <= 1e-6 * c["max_abs"] and c["min_pos_eig"] > 0):
            raise AssertionError(f"gate bisect: covariance after variant {name}: {c}")
    if launches["fast"] < 1 or launches["lk"] < 3 * int(STUDY_DURATION * 10):
        raise AssertionError(f"studies missed a kernel: {launches}")
    if st["seconds"] > STUDY_BUDGET_S:  # reported, not failed: the shared host sets the pace
        for out in (sys.stdout, sys.stderr):
            print(f"studies: OVER their {STUDY_BUDGET_S:.0f} s budget ({st['seconds']:.2f} s): "
                  "shorten STUDY_DURATION or STUDY_GATE_FRAMES", file=out)


def study_kernels(torch, fast, lk, st, card) -> float:
    """K1 and K2 on the harsh pass's last frame (timed) and its black frame,
    against their plain versions, and on an all-zero frame: K1's map all
    zero, K2's ``ok`` all false (the compiled facade's frames replayed
    eagerly, ``_KernelInputs``). Returns K2's largest flow difference."""
    k_in, thr = st["k_in"].replay(), st["fast_threshold"]
    last = [k_in.k1[s] for s in sorted(k_in.k1, reverse=True)]
    err = hold_kernels(torch, fast, lk, last, k_in.k2, thr, "the harsh pass's last frame", card)
    black = [k_in.k1_keep[s] for s in sorted(k_in.k1_keep, reverse=True)]
    print(f"the harsh pass's black frame {STUDY_BLACK_FRAME}: K1 on {len(black)} images, K2 on "
          f"{len(k_in.k2_keep)} levels; largest corrected pixel "
          f"{max([float(x.abs().max()) for x in black] or [0.0])}")
    if len(k_in.k2_keep) < 3:
        raise AssertionError("K2 was not launched on the black frame")
    err = max(err, hold_kernels(torch, fast, lk, black, k_in.k2_keep, thr,
                                f"the black frame {STUDY_BLACK_FRAME}", card, timed=False))
    zero = torch.zeros((1, H, W), device="cuda")
    score = fast.fast_score_nms(zero, thr)
    args = k_in.k2[-1]
    z_args = (torch.zeros_like(args[0]), torch.zeros_like(args[1]), torch.zeros_like(args[2]),
              torch.zeros_like(args[3]), *args[4:])
    flow, ok = lk.track_level(*z_args)
    torch.cuda.synchronize()
    print(f"all-zero frame: K1 max score {float(score.abs().max())}, K2 ok {int(ok.sum())} of "
          f"{ok.numel()}, flows finite {bool(torch.isfinite(flow).all())}")
    if float(score.abs().max()) != 0.0 or bool(ok.any()) or not bool(torch.isfinite(flow).all()):
        raise AssertionError("K1 or K2 found texture, or K2 a non-finite flow, in an all-zero frame")
    return err


def run_bench(torch, params, counts, dev) -> dict:
    """Phase 13: the benchmark programs of ``utils/bench.py`` at the
    reference's sizes, each with its asserts, the last ``BENCH_TRACED``
    warm-up steps traced, K1/K2 launches read around each. Returns the
    record."""
    from x_multi_agent_torch.utils import bench

    t0 = time.perf_counter()
    programs = (  # (name, agents, program(stats) -> its number)
        ("matches", BENCH_AGENTS, lambda st: bench.bench_matches(
            params, BENCH_AGENTS, BENCH_STEPS, dev, st, BENCH_TRACED)),
        ("matches", BENCH_POINT, lambda st: bench.bench_matches(
            params, BENCH_POINT, BENCH_STEPS, dev, st, BENCH_TRACED)),
        ("batch1", 1, lambda st: bench.bench_batch1_latency(
            params, BENCH_B1_STEPS, dev, st, BENCH_TRACED)),
        ("image", BENCH_IMG_AGENTS, lambda st: bench.bench_image(
            params, BENCH_IMG_AGENTS, BENCH_IMG_STEPS, H, W, dev, st, BENCH_TRACED)),
    )
    rec = {"programs": []}
    for name, agents, run in programs:
        st = {"name": name, "agents": agents}
        counts.start()
        st["value"] = run(st)
        st["launches"] = counts.read()
        rec["programs"].append(st)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def check_bench(bn, card) -> None:
    """Phase 13's prints and checks on the record of :func:`run_bench`
    (each program's own asserts ran inside it): K1 and K2 launched by the
    image bench, by no match-driven program."""
    for st in bn["programs"]:
        tr, a = st["trace"], st["agents"]
        if st["name"] == "batch1":
            what = f"{st['value']:.3f} ms per update ({1e3 / st['value']:.1f} updates/s)"
        elif st["name"] == "matches":
            what = (f"{st['value']:.1f} updates/s per chip, {st['value'] / a:.2f} per agent, "
                    f"{st['ms_per_step']:.3f} ms/step")
        else:
            what = (f"{st['value']:.1f} agent-frames/s per chip, {st['value'] / a:.2f} per agent, "
                    f"{st['ms_per_step']:.3f} ms/frame, live features {st['live_features']}")
        health = {k: st[k] for k in ("applied_last", "min_slam_features", "max_tail_err_m")
                  if k in st}
        print(f"bench {st['name']} at {a} agents: {what}; {json.dumps(health)}; traced "
              f"({BENCH_TRACED} warm-up steps): {tr['wall_ms']:.3f} ms/step, launch calls "
              f"{tr['launch_calls']:.1f}/step, graph launches {tr['graph_launches']:.1f}/step "
              f"(device events in their graphs {_measured(tr['graph_nodes'], 1)}/step), device "
              f"busy {_measured(tr['device_busy_ms'], 3)} "
              f"ms/step from {tr['kernel_events']:.1f} kernel events, idle share "
              f"{_measured(st['device_idle_share'], 4)} of a timed step "
              f"({_measured(tr['device_idle_share'], 4)} of a traced one); launches K1 "
              f"{st['launches']['fast']} K2 {st['launches']['lk']} ({card})")
    print(f"phase 13: {bn['seconds']:.2f} s wall (budget {BENCH_BUDGET_S:.0f} s) ({card})")
    for st in bn["programs"]:
        n = st["launches"]
        if st["name"] == "image" and (n["fast"] < 1 or n["lk"] < 3 * 2 * BENCH_IMG_STEPS):
            raise AssertionError(f"the image bench missed a kernel: {n}")
        if st["name"] != "image" and any(n.values()):
            raise AssertionError(f"the {st['name']} bench launched K1/K2: {n}")
    if bn["seconds"] > BENCH_BUDGET_S:  # reported, not failed: the shared host sets the pace
        for out in (sys.stdout, sys.stderr):
            print(f"bench: OVER its {BENCH_BUDGET_S:.0f} s budget ({bn['seconds']:.2f} s): "
                  "shorten BENCH_B1_STEPS or an earlier phase", file=out)


def compiled_kernels(torch, fast, lk, cp, thr, card) -> float:
    """K1 and K2 on the eager image step's detection frame and last LK
    levels of phase 14 (A = 64: a graph keeps no input of its own after
    the frame, the eager run does) against their plain versions, timed,
    K2's flows where they are stable (:func:`hold_kernels`). Returns K2's
    largest flow difference."""
    k_in, agents = cp["k_in"], cp["k_in_agents"]
    det = [k_in.k1[s] for s in sorted(k_in.k1, reverse=True)]
    if len(det) < 2 or len(k_in.k2) < 3 or det[0].shape[0] != agents:
        raise AssertionError(f"the eager image step kept no A = {agents} kernel inputs")
    return hold_kernels(torch, fast, lk, det, k_in.k2, thr,
                        f"the eager image step (A = {agents})", card,
                        stable_floor=K2_STABLE_FLOOR)


def compiled_program(torch, params, name, agents, dev):
    """One program of phase 14 at ``agents``: (start state, per-step inputs
    (``COMPILED_STEPS + COMPILED_TRACED``), the eager step, a fresh compiled
    step, its graph sets); a step is ``(state, x) -> (state, applied)``. The
    filter step replays ``bench_sim``'s inputs from the bench's start; the
    image step renders 480x640 orbit frames for a fresh fleet started at
    rest at the origin, as phase 13's bench starts it (on these 23 frames
    the reference's covariance update in float32 lost agent 44's
    definiteness: ROADMAP C20)."""
    import numpy as np

    from x_multi_agent_torch import configs
    from x_multi_agent_torch.parallel import mesh
    from x_multi_agent_torch.utils import bench
    from x_multi_agent_torch.vio import vio
    from x_multi_agent_torch.vio.frame_step import CompiledFrameStep, frame_step
    from x_multi_agent_torch.vision import tracker

    n = COMPILED_STEPS + COMPILED_TRACED
    if name == "filter":
        xs = bench._per_step(bench.match_inputs_stacked(params, agents, n,
                                                        np.random.default_rng(0), device=dev))
        start = vio.init_at_time(params, 0.0, agents, dev, v=np.asarray(bench.SIM_V0))
        comp = mesh.agent_step_fn(params)
        steps = [bench.filter_step(params, s) for s in (mesh.agent_step(params), comp)]

        def wrap(fn):
            def step(state, x):
                fs, slots, applied = fn(*state, *x)
                return (fs, slots), applied
            return step

        return start, xs, wrap(steps[0]), wrap(steps[1]), (comp.graphs,)
    tparams = configs.flagship_tracker(params.cfg.tracks.n_matches)
    cam = configs.flagship_camera(H, W)
    frames, imu = bench.orbit_frames(agents, n, H, W, dev)
    imu = [x.to(params.tdtype) if x.is_floating_point() else x for x in imu]
    xs = [(frames[k], *(x[k] for x in imu)) for k in range(n)]
    fs, slots = vio.init_at_time(params, 0.0, agents, dev)
    start = (tracker.TrackerState.zero(tparams, agents, H, W, device=dev), fs, slots)
    comp = CompiledFrameStep(params, tparams, cam)

    def eager(state, x):
        tstate, fs, slots, _, applied = frame_step(params, tparams, cam, *state, *x)
        return (tstate, fs, slots), applied

    def compiled(state, x):
        tstate, fs, slots, _, applied = comp(*state, *x)
        return (tstate, fs, slots), applied

    return start, xs, eager, compiled, comp.graphs


def run_compiled(torch, params, counts, fast, lk, dev) -> dict:
    """Phase 14: each program of ``COMPILED_PROGRAMS`` eager and compiled
    from the same start on the same inputs. The compiled program first
    captures its graphs on its first inputs (``COMPILED_PRIME``: the image
    step's detection and keep branches), then both run ``COMPILED_STEPS``
    steps from the start in turns, every leaf of the state and ``applied``
    compared after every step and K1/K2 counted per run; then each runs
    the same window timed with CUDA events (peak memory beside it) and
    ``COMPILED_TRACED`` more steps under the profiler. The image step's
    eager K1 and K2 inputs of the compared steps are kept (``k_in``: the
    graphs launch nothing from Python after their capture, which the
    priming did). Returns the record;
    its ``finite`` reads the filter covariance of both runs, the image
    bench's own assert (its fleet starts at rest, so tracker points may run
    off)."""
    from x_multi_agent_torch.utils import bench

    t0 = time.perf_counter()
    rec = {"programs": []}
    for name, agents in COMPILED_PROGRAMS:
        start, xs, eager, compiled, graphs = compiled_program(torch, params, name, agents, dev)
        r = {"name": name, "agents": agents, "bitwise_steps": 0, "first_diff": None,
             "symbols": {key: f"{k.name}_kernel" for key, k in counts.kernels.items()}}
        counts.start()
        state = start
        for x in xs[:COMPILED_PRIME[name]]:
            state, _ = compiled(state, x)
        torch.cuda.synchronize()
        counts.read()
        r.update(graphs=sum(g.captured for g in graphs), capture_s=sum(g.capture_s for g in graphs),
                 pool_bytes=sum(g.pool_bytes for g in graphs))
        states = {"eager": start, "compiled": start}
        r["launches"] = {mode: {"fast": 0, "lk": 0} for mode in states}
        with _KernelInputs(fast, lk, keep=-1) as k_in:
            for k, x in enumerate(xs[:COMPILED_STEPS]):
                out = {}
                for mode, fn in (("eager", eager), ("compiled", compiled)):
                    counts.start()
                    states[mode], applied = fn(states[mode], x)
                    out[mode] = (states[mode], applied)
                    for key, v in counts.read().items():
                        r["launches"][mode][key] += v
                d = tree_diff(torch, out["compiled"], out["eager"], f"{name}{agents}")
                if d["bitwise"]:
                    r["bitwise_steps"] += 1
                elif r["first_diff"] is None:
                    r["first_diff"] = {"step": k, **d}
        if name == "image":
            rec["k_in"], rec["k_in_agents"] = k_in, agents
        r["applied"] = int(out["compiled"][1].sum())
        r["finite"] = all(bool(torch.isfinite(st[-2].cov).all()) for st in states.values())
        eig = torch.linalg.eigvalsh(states["eager"][-2].cov.double())
        r["worst_eig_ratio"] = float((eig[:, 0] / eig[:, -1]).min()) if r["finite"] else None
        for mode, fn in (("eager", eager), ("compiled", compiled)):
            state = start
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start_ev.record()
            for x in xs[:COMPILED_STEPS]:
                state, _ = fn(state, x)
            end_ev.record()
            torch.cuda.synchronize()
            ms = start_ev.elapsed_time(end_ev) / COMPILED_STEPS

            def one(i):
                nonlocal state
                state, _ = fn(state, xs[COMPILED_STEPS + i])

            counts.start()
            tr = bench.trace_calls(one, COMPILED_TRACED, dev, graphs if mode == "compiled" else (),
                                   names=tuple(r["symbols"].values()))
            tr["launches"] = counts.read()
            busy = tr.get("device_busy_ms")
            r[mode] = {"ms_per_step": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
                       "trace": tr, "idle_share": None if busy is None else 1.0 - busy / ms,
                       "traced_idle_share": tr.get("device_idle_share")}
        r["recaptured"] = sum(g.captured for g in graphs) != r["graphs"]
        r["kernels_read"] = all(g.kernels_read for g in graphs)
        rec["programs"].append(r)
        del start, xs, states, out, state
    rec["seconds"] = time.perf_counter() - t0
    return rec


def check_compiled(cp, card) -> None:
    """Phase 14's prints and checks on the record of :func:`run_compiled`:
    every compared step bit for bit, K1/K2 counted alike in both runs (the
    image step's K1 inside a replayed detection graph), no capture after the
    first inputs, a finite covariance, the filter's updates applied."""
    for r in cp["programs"]:
        head = f"compiled {r['name']} at {r['agents']} agents"
        for mode in ("eager", "compiled"):
            m, tr = r[mode], r[mode]["trace"]
            print(f"{head}, {mode}: {m['ms_per_step']:.3f} ms/step over {COMPILED_STEPS} steps; "
                  f"traced ({COMPILED_TRACED} steps): {tr['wall_ms']:.3f} ms/step, launch calls "
                  f"{tr['launch_calls']:.1f}/step, graph launches {tr['graph_launches']:.1f}/step "
                  f"(device events in their graphs {_measured(tr['graph_nodes'], 1)}/step), device "
                  f"busy {_measured(tr.get('device_busy_ms'), 3)} ms/step from "
                  f"{_measured(tr.get('kernel_events'), 1)} device events, idle share "
                  f"{_measured(m['idle_share'], 4)} of a timed step "
                  f"({_measured(m['traced_idle_share'], 4)} of a traced one); peak memory "
                  f"{m['peak_bytes']} bytes; launches K1 {r['launches'][mode]['fast']} K2 "
                  f"{r['launches'][mode]['lk']}; in the traced steps device events "
                  f"{json.dumps(tr.get('named_events'))} against launches counted "
                  f"{json.dumps(tr['launches'])} ({card})")
        print(f"{head}: {r['graphs']} graphs captured in {r['capture_s']:.3f} s (their K1/K2 "
              f"launches read from their kernel nodes by name: {r['kernels_read']}), pool "
              f"{r['pool_bytes']} bytes; bit for bit after {r['bitwise_steps']} of "
              f"{COMPILED_STEPS} steps (first difference {json.dumps(r['first_diff'])}); "
              f"applied in the last step {r['applied']}/{r['agents']}; the smallest / largest "
              f"eigenvalue of a covariance after them, worst agent, {r['worst_eig_ratio']} "
              f"(ROADMAP C20); eager / compiled ms per "
              f"step {r['eager']['ms_per_step'] / r['compiled']['ms_per_step']:.2f} ({card})")
    print(f"phase 14: {cp['seconds']:.2f} s wall (budget {COMPILED_BUDGET_S:.0f} s) ({card})")
    for r in cp["programs"]:
        head = f"compiled {r['name']} at {r['agents']} agents"
        if r["bitwise_steps"] != COMPILED_STEPS:
            raise AssertionError(f"{head} differs from the eager program: {r['first_diff']}")
        n = r["launches"]
        if n["eager"] != n["compiled"]:
            raise AssertionError(f"{head}: K1/K2 launches differ: {n}")
        if r["name"] == "image" and (n["compiled"]["fast"] < 1
                                     or n["compiled"]["lk"] < 3 * COMPILED_STEPS):
            raise AssertionError(f"{head} missed a kernel: {n}")
        if r["name"] != "image" and any(n["compiled"].values()):
            raise AssertionError(f"{head} launched K1/K2: {n}")
        if r["recaptured"] or r["compiled"]["trace"]["graph_launches"] < 1:
            raise AssertionError(f"{head}: captured again, or replayed no graph")
        if not r["kernels_read"]:
            raise AssertionError(f"{head}: the graphs' kernel nodes could not be read by name")
        for mode in ("eager", "compiled"):
            tr = r[mode]["trace"]
            if tr.get("device_busy_ms") is not None and any(
                    tr["named_events"][sym] != tr["launches"][key]
                    for key, sym in r["symbols"].items()):
                raise AssertionError(f"{head}, {mode}: the traced device events of K1/K2 "
                                     f"{tr['named_events']} are not the counted launches "
                                     f"{tr['launches']}")
        if not r["finite"] or (r["name"] == "filter" and r["applied"] < 0.95 * r["agents"]):
            raise AssertionError(f"{head}: covariance not finite or updates not applied")
    if cp["seconds"] > COMPILED_BUDGET_S:  # reported, not failed: the shared host sets the pace
        for out in (sys.stdout, sys.stderr):
            print(f"compiled: OVER its {COMPILED_BUDGET_S:.0f} s budget ({cp['seconds']:.2f} s): "
                  "shorten COMPILED_STEPS or an earlier phase", file=out)


def _reserved(torch) -> int:
    """``torch.cuda.memory_reserved()`` after a collection and
    ``empty_cache``: what the live objects, graph pools included, hold."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def facade_state(v) -> tuple:
    """Everything a facade holds that its programs write: the filter, the
    slots, the tracker, the photometric and the collaboration states."""
    return (v.fs, v.slots, getattr(v, "_tracker_state", None), v.photo,
            getattr(v, "_store", None), getattr(v, "_db", None), getattr(v, "_kf_meta", None),
            getattr(v, "n_collab_consumed", None))


def run_twins(torch, name, make, frame, n, agents, counts) -> dict:
    """Phase 15, one part: ``make(compiled)`` builds the compiled facades
    and their eager twins (``compiled=False``) from one start; ``frame(vs,
    k, rec)`` drives frame ``k`` of ``n``, the compiled run first, then the
    eager one; after every frame every leaf of both is compared
    (:func:`tree_diff`). Per run and frame: ms (CUDA events around the
    frame), K1/K2 launches (the compiled run's read from its graphs' kernel
    nodes) and synchronizing calls (the sync debug mode's warnings). The
    compiled run's frames run under a host-only ``torch.profiler`` trace:
    its kernel launch calls outside graphs and graph launches per frame;
    the eager run's last frame too (a device trace of its tens of thousands
    of kernels would be slow). Means over the frames in which the compiled
    run captured no graph (``steady``). Returns the record; ``vs`` holds the
    compiled facades (or programs)."""
    t0 = time.perf_counter()
    runs = {mode: make(mode == "compiled") for mode in ("compiled", "eager")}
    recs = {mode: {} for mode in runs}
    r = {"name": name, "frames": n, "agents": agents, "bitwise_frames": 0, "first_diff": None,
         **{mode: {"ms": [], "syncs": [], "calls": [], "launches": {"fast": 0, "lk": 0}}
            for mode in runs}}

    def graphs(mode):
        if mode == "eager":
            return []
        return [p.graphs for v in runs[mode] for p in getattr(v, "programs", [v])]

    steady, r["cov_finite"] = [], True
    for k in range(n):
        captured = sum(g.captured for g in graphs("compiled"))
        for mode, vs in runs.items():
            rm = r[mode]
            traced = mode == "compiled" or k == n - 1
            counts.start()
            _, ms, syncs, calls = watched_call(torch, lambda: frame(vs, k, recs[mode]), traced)
            rm["ms"].append(ms)
            rm["syncs"].append(syncs)
            rm["calls"].append(calls)
            for key, c in counts.read().items():
                rm["launches"][key] += c
        if sum(g.captured for g in graphs("compiled")) == captured:
            steady.append(k)
        d = tree_diff(torch, *(tuple(facade_state(v) if hasattr(v, "fs") else v.state
                                     for v in runs[mode]) for mode in ("compiled", "eager")),
                      f"{name}[{k}]")
        if d["bitwise"]:
            r["bitwise_frames"] += 1
        elif r["first_diff"] is None:
            r["first_diff"] = {"frame": k, **d}
        covs = [v.fs.cov if hasattr(v, "fs") else v.state[0].cov for v in runs["compiled"]]
        if r["cov_finite"] and not all(bool(torch.isfinite(c).all()) for c in covs):
            r["cov_finite"] = f"not finite after frame {k}"  # ROADMAP C20's witness
    ks = steady or list(range(n))
    for mode in runs:
        rm = r[mode]
        rm["ms_steady"] = sum(rm["ms"][k] for k in ks) / (len(ks) * agents)
        rm["ms_all"] = sum(rm["ms"]) / (n * agents)
        rm["syncs_per_frame"] = sum(rm["syncs"][k] for k in ks) / len(ks)
    c = r["compiled"]
    calls = [c["calls"][k][0] / agents for k in ks]
    c["launch_calls"], c["launch_calls_max"] = sum(calls) / len(calls), max(calls)
    c["graph_launches"] = sum(c["calls"][k][1] for k in ks) / len(ks)
    r["eager"]["launch_calls"] = r["eager"]["calls"][-1][0] / agents
    gs = graphs("compiled")
    r.update(steady_frames=len(steady), captures=sum(g.captured for g in gs),
             capture_s=sum(g.capture_s for g in gs), pool_bytes=sum(g.pool_bytes for g in gs),
             kernels_read=all(g.kernels_read for g in gs), records=recs,
             seconds=time.perf_counter() - t0)
    r["vs"] = runs["compiled"]
    return r


class _RoundTwin:
    """``collab.collaborative_round`` as a one-agent-set "facade" for
    :func:`run_twins`: ``state`` the fleet's filter state and the last
    round's counts, a frame one round (compiled: its program)."""

    def __init__(self, params, ccfg, fs, compiled):
        from x_multi_agent_torch.parallel import collab

        self.params, self.ccfg = params, ccfg
        self.fn = (collab.collaborative_round_fn(params, ccfg) if compiled else
                   (lambda fs: collab.collaborative_round(params, ccfg, fs)))
        self.programs = [self.fn] if compiled else []
        self.state = (fs, None)

    def __call__(self):
        self.state = self.fn(self.state[0])
        return self.state


def check_twins(tw, card) -> None:
    """Phase 15's prints and checks on the records of :func:`run_twins`:
    every frame bit for bit, K1/K2 counted alike (read from the graphs'
    kernel nodes), fewer than 100 kernel launch calls outside graphs per
    agent-frame over the frames that captured nothing (the pair's exchange
    frames run the request-response calls eagerly, as the reference does:
    their most is printed), at least one graph launch per frame."""
    for r in tw["parts"]:
        c, e = r["compiled"], r["eager"]
        print(f"phase 15 {r['name']} ({r['agents']} agents x {r['frames']} frames): ms per "
              f"agent-frame over the {r['steady_frames']} frames that captured nothing: compiled "
              f"{c['ms_steady']:.3f}, eager {e['ms_steady']:.3f} (eager / compiled "
              f"{e['ms_steady'] / c['ms_steady']:.2f}); over all frames: compiled "
              f"{c['ms_all']:.3f}, eager {e['ms_all']:.3f}; kernel launch calls outside graphs "
              f"per agent-frame, compiled {c['launch_calls']:.1f} (at most "
              f"{c['launch_calls_max']:.1f}), eager {e['launch_calls']:.1f} (its last frame); "
              f"graph launches per frame {c['graph_launches']:.1f}; host syncs per frame "
              f"{c['syncs_per_frame']:.2f} compiled, {e['syncs_per_frame']:.2f} eager; "
              f"{r['captures']} graphs captured in {r['capture_s']:.3f} s, pool "
              f"{r['pool_bytes']} bytes; K1/K2 launches compiled {c['launches']} (read from the "
              f"graphs' kernel nodes: {r['kernels_read']}), eager {e['launches']}; bit for bit "
              f"after {r['bitwise_frames']} of {r['frames']} frames (first difference "
              f"{json.dumps(r['first_diff'])}); every covariance finite after every frame: "
              f"{r['cov_finite']}; {r['seconds']:.2f} s ({card})")
    print(f"phase 15: {tw['seconds']:.2f} s wall (budget {TWIN_BUDGET_S:.0f} s) ({card})")
    for r in tw["parts"]:
        c, e = r["compiled"], r["eager"]
        head = f"phase 15 {r['name']}"
        if r["bitwise_frames"] != r["frames"]:
            raise AssertionError(f"{head}: compiled differs from eager: {r['first_diff']}")
        if c["launches"] != e["launches"] or not r["kernels_read"]:
            raise AssertionError(f"{head}: K1/K2 launches differ or were not read from the "
                                 f"graphs: {c['launches']} vs {e['launches']}")
        if c["launch_calls"] >= 100 or c["graph_launches"] < 1:
            raise AssertionError(f"{head}: {c['launch_calls']} launch calls per agent-frame, "
                                 f"{c['graph_launches']} graph launches per frame")
    if tw["seconds"] > TWIN_BUDGET_S:  # reported, not failed: the shared host sets the pace
        for out in (sys.stdout, sys.stderr):
            print(f"phase 15: OVER its {TWIN_BUDGET_S:.0f} s budget ({tw['seconds']:.2f} s): "
                  "shorten TWIN_FRAMES", file=out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "x_multi_agent_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from x_multi_agent_torch import configs, native
    from x_multi_agent_torch.ekf import ekf as ekf_mod
    from x_multi_agent_torch.parallel import collab
    from x_multi_agent_torch.utils.bench import card_line
    from x_multi_agent_torch.utils.scene import orbit_dataset, orbit_start
    from x_multi_agent_torch.vio import vio
    from x_multi_agent_torch.vio.frame_step import frame_step
    from x_multi_agent_torch.vision import fast, lk, tracker

    # ---- 0. card and build -------------------------------------------------
    dev = torch.device("cuda")
    card = card_line(dev)
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    native.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {native.build_seconds} s)")
    print(native.build_log.strip())

    t0 = time.perf_counter()
    frames, imu = orbit_dataset(N_AGENTS, N_WARM + N_TIMED, H, W, dev)
    torch.cuda.synchronize()
    print(f"dataset: {tuple(frames.shape)} frames rendered in {time.perf_counter() - t0:.2f} s")
    params = configs.flagship_params()
    tparams = configs.flagship_tracker(params.cfg.tracks.n_matches)
    cam = configs.flagship_camera(H, W)
    records = {}
    counts = _Launches({"fast": fast.K1, "lk": lk.K2})

    _no_jax()

    # ---- 1. K1 against its plain version -----------------------------------
    pyr0, pyr1, det_levels, pts, live = kernel_inputs(torch, tparams, frames[0], frames[1])
    k1_err = 0.0
    for img in det_levels + [lvl[:1].contiguous() for lvl in det_levels]:
        got = fast.fast_score_nms(img, tparams.fast_threshold, nms=True)
        ref = fast.nms3(fast.fast_score(img, tparams.fast_threshold))
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        print(f"K1 {tuple(img.shape)}: max |kernel - plain| = {err}, corners = {int((ref > 0).sum())}")
        if err != 0.0:  # subtract/min/max/compare only: bit-exact
            raise AssertionError("K1 differs from its plain version")
        k1_err = max(k1_err, err)
    records["fast"] = {"max_abs_err": k1_err}

    _no_jax()

    # ---- 2. K2 against its plain version -----------------------------------
    # the slice's inputs: 200 detected features per agent on frame 0, tracked
    # into frame 1 level by level (each level's guess from the plain
    # version's coarser level, the same for both)
    print(f"K2 inputs: {int(live.sum())} features over {N_AGENTS} agents")
    k2_err = 0.0
    for half_win in (tparams.win_half, 15):
        levels = k2_level_inputs(torch, lk, tparams, pyr0, pyr1, pts, half_win)
        for args, (f_p, ok_p) in levels:
            f_k, ok_k = lk.track_level(*args)
            torch.cuda.synchronize()
            margin = lk.gate_margin(args[2], args[3], args[4], half_win, tparams.min_eig_thr)
            stt = lk.level_agreement(f_p, ok_p, f_k, ok_k, margin)
            print(f"K2 half_win={half_win} level {tuple(args[0].shape)}: {json.dumps(stt)}")
            if not k2_agrees(stt):
                raise AssertionError(f"K2 differs from its plain version at {tuple(args[0].shape)}")
            k2_err = max(k2_err, stt["max_flow_err"])
        if half_win == tparams.win_half:
            level_inputs = [args for args, _ in levels]
    records["lk"] = {"max_abs_err": k2_err}

    _no_jax()

    # ---- 3. the slice --------------------------------------------------------
    p0, v0, q0 = orbit_start(N_AGENTS)
    fs, slots = vio.init_at_time(params, 0.0, N_AGENTS, dev, p=p0, v=v0, q=q0)
    tstate = tracker.TrackerState.zero(tparams, N_AGENTS, H, W, device=dev)
    times, seqs, w_ms, a_ms = imu
    n_applied = torch.zeros((), dtype=torch.int64, device=dev)
    counts.start()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for k in range(N_WARM + N_TIMED):
        if k == N_WARM:
            torch.cuda.synchronize()
            start.record()
        tstate, fs, slots, matches, applied = frame_step(
            params, tparams, cam, tstate, fs, slots, frames[k], times[k], seqs[k],
            w_ms[k], a_ms[k], times[k][:, -1],
        )
        n_applied = n_applied + applied.sum()
    end.record()
    torch.cuda.synchronize()
    launches = counts.read()
    n_applied = int(n_applied)
    elapsed_ms = start.elapsed_time(end)
    n_live = int((tstate.ids >= 0).sum())
    fps = N_AGENTS * N_TIMED / (elapsed_ms / 1e3)
    print(f"slice: {N_AGENTS} agents x {N_TIMED} timed frames: {elapsed_ms / N_TIMED:.3f} ms/frame, "
          f"{fps:.1f} agent-frames/s; updates applied {n_applied}/{N_AGENTS * (N_WARM + N_TIMED)}; "
          f"live features {n_live}; matches in the last frame {int(matches.valid.sum())}; "
          f"launches K1 {launches['fast']} K2 {launches['lk']}")
    if n_live < 10 * N_AGENTS:
        raise AssertionError(f"tracker degenerate: {n_live} live features")
    if not bool(torch.isfinite(fs.cov).all()):
        raise AssertionError("filter covariance not finite")
    if launches["fast"] < 1 or launches["lk"] < 3 * (N_WARM + N_TIMED):
        raise AssertionError(f"main path missed a kernel: {launches}")
    _no_jax()

    # ---- 4. kernel times per launch at the slice shapes, against the bound --
    times = kernel_times(torch, fast, lk, det_levels, level_inputs, tparams.fast_threshold)
    for name, r in times.items():
        records[name].update(r)
        print(f"time {name} per launch (mean of {r['launches_per_frame']} per frame): device "
              f"{r['device_ms']:.4f} ms (CUDA graph), profiler {_profiled(r)}, events "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes_per_frame']} bytes, {r['ops_per_frame']} operations "
              f"per frame), share of bound {r['share_of_bound']:.3f} ({card})")

    _no_jax()

    # ---- 5. collaborative rounds on the image path --------------------------
    ccfg = collab.CollabConfig()
    counts.start()
    fs, rounds, nbytes = run_collab(
        torch, params, tparams, cam, ccfg, (p0, v0, q0), frames, imu, N_COLLAB, ROUND_EVERY, dev)
    launches = counts.read()
    for i, r in enumerate(rounds):
        print(f"collab round {i + 1}: {r['ms']:.3f} ms, matches fused {r['fused']} "
              f"(per agent {r['fused_per_agent']}), min eigenvalue of the position "
              f"covariance {r['min_pos_eig']:.6g}, max |P - P^T| {r['max_asym']:.3g} ({card})")
    fleet = fs  # phase 15 rounds on it again
    tail = ekf_mod.tail_core(fs)
    print(f"collab: {N_COLLAB} frames, {len(rounds)} rounds at {N_AGENTS} agents, "
          f"{sum(r['fused'] for r in rounds)} matches fused, payload {nbytes} bytes per agent, "
          f"launches K1 {launches['fast']} K2 {launches['lk']}")
    if sum(r["fused"] for r in rounds) <= 0:
        raise AssertionError("the collaborative rounds fused no match")
    if not bool(torch.isfinite(fs.cov).all()) or not bool(torch.isfinite(tail.p).all()):
        raise AssertionError("collaborative state not finite")
    if launches["fast"] < 1 or launches["lk"] < 3 * N_COLLAB:
        raise AssertionError(f"collaboration path missed a kernel: {launches}")
    _no_jax()

    # ---- 6. the single-agent facade -----------------------------------------
    shapes = []
    dispatch = fast.fast_score_nms

    def watch(imgs, *args, **kwargs):  # records the shapes K1 is launched on
        shapes.append(tuple(imgs.shape))
        return dispatch(imgs, *args, **kwargs)

    fast.fast_score_nms = watch
    counts.start()
    try:
        # agent 0's IMU stream as the host delivers it; its frames stay on the card
        host_imu = tuple(x[:N_FACADE, :1].cpu().numpy() for x in imu)
        v, n_applied, elapsed_ms = run_facade(
            torch, params, tparams, cam, frames[:N_FACADE, :1], host_imu, (p0[:1], v0[:1], q0[:1]),
            dev)
    finally:
        fast.fast_score_nms = dispatch
    launches = counts.read()
    print(f"facade: 1 agent x {N_FACADE} frames: {_frame_ms(elapsed_ms)}; {_captures([v])}; "
          f"updates applied {n_applied}/{N_FACADE}; re-inits {v.n_reinits}; K1 shapes "
          f"{sorted(set(shapes))}; launches K1 {launches['fast']} K2 {launches['lk']} ({card})")
    if n_applied < 0.9 * N_FACADE or v.n_reinits != 0:
        raise AssertionError("facade updates not applied")
    if not bool(torch.isfinite(v.tail_state().p).all()):
        raise AssertionError("facade tail not finite")
    if launches["fast"] < 1 or (1, H, W) not in shapes or launches["lk"] < 3 * N_FACADE:
        raise AssertionError(f"facade path missed a kernel: {launches}, {shapes}")
    _no_jax()

    # ---- 7. the request-response fleet ---------------------------------------
    tparams_desc = tparams._replace(compute_descriptors=True)
    counts.start()
    fs, words, rc = run_request_comm(torch, params, tparams_desc, cam, (p0, v0, q0),
                                     frames[:N_RC], tuple(x[:N_RC] for x in imu), dev)
    launches = counts.read()
    pairs = N_AGENTS * (N_AGENTS - 1)
    for r in rc["rounds"]:
        rr_bytes = pairs * rc["vlad_bytes"] + r["hits"] * rc["payload_bytes"]
        full_bytes = pairs * rc["payload_bytes"]
        r["bytes_rr"], r["bytes_full"] = rr_bytes, full_bytes
        print(f"request-response round after frame {r['after_frame']}: {r['ms']:.3f} ms, hits "
              f"{r['hits']} (per requester {r['hits_per_requester']}), matches fused {r['fused']} "
              f"(per agent {r['fused_per_agent']}), bytes {rr_bytes} vs full broadcast "
              f"{full_bytes} ({rr_bytes / full_bytes:.4f}), covariance finite {r['finite']}, "
              f"max |P - P^T| {r['max_asym']:.3g}, min eigenvalue of the position covariance "
              f"{r['min_pos_eig']:.6g} ({card})")
    m = rc["msckf_round"]
    print(f"joint-MSCKF round: {m['ms']:.3f} ms, matches fused {m['fused']} (per agent "
          f"{m['fused_per_agent']}), covariance finite {m['finite']}, max |P - P^T| "
          f"{m['max_asym']:.3g}, min eigenvalue of the position covariance "
          f"{m['min_pos_eig']:.6g} ({card})")
    print(f"request-response fleet: {N_AGENTS} agents x {N_RC} frames, keyframes per agent "
          f"{rc['keyframes_per_agent']}, vocabulary of {N_WORDS} words from "
          f"{rc['vocab_from']} descriptors, VLAD {rc['vlad_bytes']} bytes, payload "
          f"{rc['payload_bytes']} bytes, descriptors {rc['desc_ms']:.4f} ms per frame, "
          f"bits vs CPU float64 {json.dumps(rc['desc_bits'])}, launches K1 {launches['fast']} "
          f"K2 {launches['lk']} ({card})")
    checks = rc["rounds"] + [m]
    if sum(rc["keyframes_per_agent"]) < 1 or sum(r["hits"] for r in rc["rounds"]) < 1:
        raise AssertionError("the request-response fleet selected no keyframe or had no hit")
    if sum(r["fused"] for r in rc["rounds"]) < 1:
        raise AssertionError("the request-response rounds fused no match")
    if not all(r["finite"] and r["max_asym"] <= 1e-6 * r["max_abs"] for r in checks):
        raise AssertionError("request-response covariance not finite or not symmetric")
    if rc["desc_bits"]["bit_agree"] < 0.99 or rc["desc_bits"]["n_keypoints"] < N_AGENTS:
        raise AssertionError(f"card descriptors disagree with the CPU's: {rc['desc_bits']}")
    if launches["fast"] < 1 or launches["lk"] < 3 * N_RC:
        raise AssertionError(f"request-response path missed a kernel: {launches}")
    _no_jax()

    # ---- 8. the collaborating facade pair ------------------------------------
    shapes.clear()
    fast.fast_score_nms = watch
    counts.start()
    try:
        host_imu = tuple(x[:N_FACADE, :2].cpu().numpy() for x in imu)
        vs, fp = run_facade_pair(torch, params, tparams_desc, cam, frames[:N_FACADE, :2],
                                 host_imu, (p0, v0, q0), words, dev)
    finally:
        fast.fast_score_nms = dispatch
    launches = counts.read()
    print(f"facade pair: 2 agents x {N_FACADE} frames with collaboration: "
          f"{_frame_ms(fp['ms'], 2)}; {_captures(vs)}; updates applied "
          f"{fp['applied']}/{2 * N_FACADE}; re-inits {fp['reinits']}; keyframes {fp['keyframes']}; "
          f"hits {fp['hits']}; matches fused {fp['fused']}; recorded into the store "
          f"{fp['stored']}; consumed {fp['consumed']}; bytes {fp['bytes_rr']} vs full broadcast "
          f"{fp['bytes_full']} ({fp['bytes_rr'] / fp['bytes_full']:.4f}); K1 shapes "
          f"{sorted(set(shapes))}; launches K1 {launches['fast']} K2 {launches['lk']} ({card})")
    if fp["applied"] < 0.9 * 2 * N_FACADE or any(fp["reinits"]):
        raise AssertionError("facade pair updates not applied")
    if not all(bool(torch.isfinite(v.tail_state().p).all()) for v in vs):
        raise AssertionError("facade pair tail not finite")
    if sum(fp["keyframes"]) < 1 or fp["hits"] < 1 or fp["fused"] < 1:
        raise AssertionError("the facade pair selected no keyframe, had no hit or fused nothing")
    if launches["fast"] < 1 or (1, H, W) not in shapes or launches["lk"] < 3 * N_FACADE:
        raise AssertionError(f"facade pair path missed a kernel: {launches}, {shapes}")
    _no_jax()

    # ---- 9. the thermal facade ---------------------------------------------
    from x_multi_agent_torch.utils import scene

    clean = frames[:N_FACADE, 0]
    raw = scene.degrade_frames(clean, THERMAL_GAINS, THERMAL_VIGNETTE, THERMAL_NOISE,
                               torch.Generator(device=dev).manual_seed(9))
    host_imu = tuple(x[:N_FACADE, :1].cpu().numpy() for x in imu)
    thermal = {}
    for name, spatial in (("A", False), ("B", True)):
        shapes.clear()
        fast.fast_score_nms = watch
        counts.start()
        try:
            v, tr = run_thermal(torch, params, tparams, cam, raw[:, None], clean, host_imu,
                                (p0[:1], v0[:1], q0[:1]), spatial, dev)
        finally:
            fast.fast_score_nms = dispatch
        launches = counts.read()
        thermal[name] = tr
        g, ut = tr["gains"], tr["update_trace"]
        at = {f: [round(float(g[f - 1, 0]), 6), round(float(g[f - 1, 1]), 6)] for f in (10, 20, 30)}
        print(f"thermal facade run {name} (spatial {spatial}): 1 agent x {N_FACADE} frames: "
              f"{_frame_ms(tr['ms'])} (phase 6: {_frame_ms(elapsed_ms)}); {_captures([v])}; "
              f"photometric update {tr['update_ms']:.3f} ms/frame (CUDA events); traced (10 "
              f"updates): {ut['wall_ms']:.3f} ms, {ut['launch_calls']:.1f} launch calls and "
              f"{ut['graph_launches']:.1f} graph launches ({_measured(ut['graph_nodes'], 1)} device "
              f"events) per update, device busy {_measured(ut.get('device_busy_ms'), 4)} ms, idle "
              f"share {_measured(ut.get('device_idle_share'), 4)}; updates applied "
              f"{tr['applied']}/{N_FACADE}; re-inits "
              f"{tr['reinits']}; gains after frames 10/20/30 {at} against baked "
              f"{[THERMAL_GAINS[f - 1] for f in (10, 20, 30)]}; mean |corrected - clean| "
              f"{tr['err_corrected']:.3f} vs |raw - clean| {tr['err_raw']:.3f} gray levels over "
              f"the last 10 frames; synchronizing calls per extra update (solve due, call sites) {tr['syncs']}; "
              f"map solved {tr['solved']} {tr.get('map_range')}; K1 shapes {sorted(set(shapes))}; "
              f"launches K1 {launches['fast']} K2 {launches['lk']} ({card})")
        if tr["applied"] < 0.9 * N_FACADE or tr["reinits"] != 0:
            raise AssertionError(f"thermal facade {name}: updates not applied")
        if not bool(torch.isfinite(v.tail_state().p).all()):
            raise AssertionError(f"thermal facade {name}: tail not finite")
        if not bool(torch.isfinite(g).all()) or not bool((g[:, 0] - g[:, 1] > 0).all()):
            raise AssertionError(f"thermal facade {name}: gains not finite or a - b <= 0")
        if launches["fast"] < 1 or (1, H, W) not in shapes or launches["lk"] < 3 * N_FACADE:
            raise AssertionError(f"thermal facade {name} missed a kernel: {launches}, {shapes}")
        if any(where for due, where in tr["syncs"] if not due):
            raise AssertionError(f"thermal facade {name}: a host wait in the update: {tr['syncs']}")
        if spatial and not (tr["solved"] and tr["map_finite"]):
            raise AssertionError("thermal facade B: the spatial map was not solved or not finite")
    if not thermal["A"]["err_corrected"] < thermal["A"]["err_raw"]:
        raise AssertionError("thermal facade A: the correction moved the images away from clean")
    _no_jax()

    # ---- 10. the multi-rank exchange -------------------------------------------
    ex = run_exchange(torch, params, words, dev)
    check_exchange(ex, counts, card)
    _no_jax()

    # ---- 11. the dataset-replay ATE report -------------------------------------
    reserved = [("before phase 11", _reserved(torch))]
    counts.start()
    ate = run_ate_report(torch, dev)
    launches = counts.read()
    check_ate_report(ate, launches, card)
    _no_jax()
    records["lk"]["max_abs_err"] = max(records["lk"]["max_abs_err"],
                                       ate_kernels(torch, fast, lk, ate, card))
    reserved.append(("after phase 11", _reserved(torch)))
    _no_jax()

    # ---- 12. the ATE-report studies ---------------------------------------------
    counts.start()
    st = run_studies(torch, dev)
    launches = counts.read()
    check_studies(st, launches, card)
    _no_jax()
    records["lk"]["max_abs_err"] = max(records["lk"]["max_abs_err"],
                                       study_kernels(torch, fast, lk, st, card))
    reserved.append(("after phase 12", _reserved(torch)))
    alive = sum(ref() is not None for ref in ate["facades"] + st["facades"])
    print(f"memory reserved (collected) {json.dumps(dict(reserved))} bytes; facades of phases "
          f"11-12 still alive {alive} of {len(ate['facades']) + len(st['facades'])} ({card})")
    if alive:
        raise AssertionError(f"{alive} dropped facades of phases 11-12 kept their graphs")
    _no_jax()

    # ---- 13. the benchmark programs -----------------------------------------------
    bn = run_bench(torch, params, counts, dev)
    check_bench(bn, card)
    _no_jax()

    # ---- 14. the compiled programs against the eager ones ----------------------------
    cp = run_compiled(torch, params, counts, fast, lk, dev)
    check_compiled(cp, card)
    _no_jax()
    records["lk"]["max_abs_err"] = max(records["lk"]["max_abs_err"], compiled_kernels(
        torch, fast, lk, cp, tparams.fast_threshold, card))
    _no_jax()

    # ---- 15. the compiled facades against their eager twins -------------------------
    t15 = time.perf_counter()
    host1 = tuple(x[:TWIN_FRAMES, :1].cpu().numpy() for x in imu)
    host2 = tuple(x[:TWIN_FRAMES, :2].cpu().numpy() for x in imu)
    start1, start2 = (p0[:1], v0[:1], q0[:1]), (p0[:2], v0[:2], q0[:2])
    tw = {"parts": []}
    for name, agents, n, path in (
            ("facade", 1, TWIN_FRAMES, facade_path(
                params, tparams, cam, frames[:TWIN_FRAMES, :1], host1, start1, dev)),
            ("facade pair", 2, TWIN_PAIR_FRAMES, facade_path(
                params, tparams_desc, cam, frames[:TWIN_FRAMES, :2], host2, start2, dev,
                words=words)),
            ("thermal facade B", 1, TWIN_FRAMES, facade_path(
                params, tparams, cam, raw[:TWIN_FRAMES, None], host1, start1, dev,
                photometric=thermal_photometric(True)))):
        if name.startswith("thermal"):
            with _PhotoInputs() as photo_in:  # the eager twin's last calibration inputs
                tw["parts"].append(run_twins(torch, name, *path, n, agents, counts))
        else:
            tw["parts"].append(run_twins(torch, name, *path, n, agents, counts))
        _no_jax()
    tw["parts"].append(run_twins(
        torch, f"full-map round ({N_AGENTS} agents, per round)",
        lambda compiled: [_RoundTwin(params, ccfg, fleet, compiled)],
        lambda vs, k, rec: vs[0](), TWIN_ROUNDS, 1, counts))
    tw["seconds"] = time.perf_counter() - t15
    check_twins(tw, card)
    _no_jax()
    if "solve" not in photo_in.last:
        raise AssertionError("phase 15: the thermal facade solved no spatial map")
    cmp = photo_card_vs_cpu(torch, photo_in.last)
    print(f"thermal card vs CPU float64 (run B's last inputs, from its eager twin): |da| "
          f"{cmp['da']:.3g}, |db| {cmp['db']:.3g}, centred map max diff "
          f"{cmp['map_centred_err']:.3g} (map scale {cmp['map_scale']:.3g}), mean offset "
          f"{cmp['map_offset']:.3g}; cells per connected component {cmp['components']}, their "
          f"offsets {cmp['component_offsets']}, map max diff with those offsets removed "
          f"{cmp['map_err_per_component']:.3g} ({card})")
    if cmp["da"] > 1e-4 or cmp["db"] > 1e-4 or cmp["map_err_per_component"] > 1e-3:
        raise AssertionError(f"thermal facade: the card's calibration disagrees with the CPU's: {cmp}")
    _no_jax()

    kernels = []
    for name, k in (("fast", fast.K1), ("lk", lk.K2)):
        r = records[name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": counts.total[name], "max_abs_err": r["max_abs_err"],
            **{key: r[key] for key in ("ms", "device_ms", "profiler_ms", "plain_ms", "bound_ms",
                                       "bound_by", "share_of_bound", "launches_per_frame",
                                       "library_ms")},
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
