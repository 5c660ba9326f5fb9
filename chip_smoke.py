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
     levels, per launch: the CUDA-event time, the device time from a
     ``torch.profiler`` trace of the same calls (summed over the kernel's
     own symbol), the plain version's time and the bound (the larger of the
     bytes over 3.35 TB/s and the operations over the fp32 peak, counted
     for these inputs: see ``k1_work`` and ``k2_work``);
  5. collaboration: a fresh fleet of the same 16 agents from their
     initial states through ``frame_step`` for 10 frames, with a full-map
     exchange round (``collab.collaborative_round``, the reference's
     default ``CollabConfig``) after the 5th and the 10th, each timed with
     CUDA events; matches fused (> 0 over both rounds), the covariance
     finite and symmetric with the smallest position-block eigenvalue
     printed, every tail position finite, K1 and K2 launched on this path
     (a fleet's first frame always detects; continuing phase 3's fleet
     instead, no agent falls below the detection threshold in 10 frames);
  6. the single-agent ``VIO`` facade on agent 0's 30 frames and IMU:
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
     events) and launches per frame (host launch calls in a
     ``torch.profiler`` trace of 10 further updates, which also count the
     synchronizing operations), the gains against the baked ones at frames
     10, 20 and 30; asserts >= 90 % applied, no re-init, a finite tail, the
     gains finite with a - b > 0 on every frame, K1 on a (1, 480, 640)
     frame, K2 >= 3 launches per frame, no synchronizing operation in an
     update that solves no map, and in run B a solved finite map; in run A
     the corrected images of the last 10 frames closer to the clean render
     than the raw ones; the inputs of run B's last ``process_frame`` and
     last spatial solve through the port on the CPU in float64: |da|, |db|
     <= 1e-4, the maps within 1e-3 once each connected component of the
     seen cells takes its own fitted offset (the centred difference and the
     mean offset printed);
 10. the multi-rank exchange (``parallel/mesh.py``): (a) 2 gloo ranks, both
     on the one card (``mesh.spawn_agents``), each run phase 7's fleet on
     its block of 8 agents (rendered in the rank, ``frame_step`` with
     descriptors and the keyframe step for 20 frames, phase 7's words), then
     ``sharded_collab_round_desc`` and ``sharded_collab_round``, timed with
     CUDA events, with the bytes each collective shipped; the
     single-process rounds on the gathered pre-round states (the same keyed
     RANSAC draws) give the same integers and floats within 1e-4 of each
     leaf's max; asserts >= 90 % applied, finite covariances, K1 and K2
     (>= 3 per frame) launched in each rank, a hit and a fused match; (b)
     the same two sharded rounds in this process at NCCL world size 1 on
     all 16 agents: bit for bit the single-process rounds; (c)
     ``dryrun.dryrun_multichip`` on 2 gloo ranks of 2 agents on the card,
     with its checks. The phase's wall time is printed.

The last three lines of standard output are the kernels' JSON record (the
launch counts summed over the paths of phases 3, 5-9 and 10's ranks, each
read from 0 around its path; phase 4's times per launch), the card's ``nvidia-smi``
name and power limit, and the result JSON.
"""
import json
import os
import subprocess
import sys
import time

N_AGENTS, H, W = 16, 480, 640
N_WARM, N_TIMED, N_COLLAB = 10, 20, 10
ROUND_EVERY = 5  # collaborative rounds after every 5th frame
N_FACADE = N_WARM + N_TIMED
N_RC, RC_ROUNDS = 20, (15, 20)  # request-response fleet: frames, rounds after these
N_WORDS, EXCHANGE_EVERY = 64, 3
N_RANKS = 2  # phase 10: gloo ranks of the multi-rank exchange, all on the one card
# phase 9: the reference's thermal e2e drift, the accuracy report's vignette
# and noise, its calibration budget; spatial cells and cadence
THERMAL_GAINS = [(1.0 + 0.01 * k, 0.002 * k) for k in range(N_FACADE)]
THERMAL_VIGNETTE, THERMAL_NOISE, PHOTO_OBS = 0.06, 0.006, 80
CELL_PX, SPATIAL_EVERY = 40, 10
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 bytes/s, fp32
# flop/s outside the tensor cores (an FMA counts 2), and fp32 instructions/s
# that are not FMAs (min, max, compare, add: one per lane per clock)
PEAK_BYTES, PEAK_FLOPS, PEAK_OPS = 3.35e12, 67e12, 33.5e12


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def _device_us(event) -> float:
    """Device time of one profiler event (the attribute was renamed across
    torch versions)."""
    for attr in ("device_time", "cuda_time", "self_device_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    raise AttributeError("profiler event has no device time")


def device_ms(torch, fn, symbol: str, reps: int = 20, tries: int = 3) -> float:
    """Mean device milliseconds of the kernel whose name holds ``symbol``,
    from a ``torch.profiler`` trace of ``reps`` calls of ``fn`` (after a
    warm-up call), each launching it once. The tracer sometimes drops
    events (11 of 40 kept once): the mean is over the launches it kept, the
    trace is taken again while it kept fewer than half, and it fails if it
    keeps none."""
    from torch.profiler import ProfilerActivity, profile

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
        raise AssertionError(f"the profiler saw no launch of {symbol}")
    return sum(_device_us(e) for e in evs) / 1e3 / len(evs)


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


def kernel_times(torch, fast, lk, det_levels, level_inputs, thr) -> dict:
    """K1 on one detection frame's levels and K2 on one frame's LK levels,
    per launch (means over the frame's launches): CUDA-event ms, profiler
    device ms (each level traced on its own), the plain version's ms, the
    bound and what bounds it."""
    calls = {
        "fast": ("fast_score_nms_kernel",
                 [lambda i=i: fast.fast_score_nms(i, thr) for i in det_levels],
                 lambda: [fast.nms3(fast.fast_score(i, thr)) for i in det_levels],
                 [k1_work(torch, fast, i, thr) for i in det_levels], PEAK_OPS),
        "lk": ("lk_level_kernel",
               [lambda a=a: lk.track_level(*a) for a in level_inputs],
               lambda: [lk._track_level(*a) for a in level_inputs],
               [k2_work(torch, lk, a) for a in level_inputs], PEAK_FLOPS),
    }
    out = {}
    for name, (symbol, launches, plain, work, peak) in calls.items():
        n = len(work)
        t_bytes = sum(b for b, _ in work) / PEAK_BYTES * 1e3
        t_ops = sum(o for _, o in work) / peak * 1e3
        bound = sum(max(b / PEAK_BYTES, o / peak) for b, o in work) * 1e3 / n
        r = {"ms": _ms(torch, lambda: [f() for f in launches]) / n,
             "device_ms": sum(device_ms(torch, f, symbol) for f in launches) / n,
             "plain_ms": _ms(torch, plain) / n, "bound_ms": bound,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None, "launches_per_frame": n,
             "bytes_per_frame": sum(b for b, _ in work), "ops_per_frame": sum(o for _, o in work)}
        r["share_of_bound"] = r["bound_ms"] / r["device_ms"]
        out[name] = r
    return out


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


def run_facade(torch, params, tparams, cam, frames, imu, start, device):
    """One agent's frames (n, 1, H, W) and host IMU windows (numpy, (n, 1,
    L, ...)) through the single-agent facade, started at ``start`` = (p, v,
    q). Returns (the facade, applied count, elapsed ms)."""
    from x_multi_agent_torch.vio.vio import VIO

    times, seqs, w_ms, a_ms = imu
    v = VIO(params, device=device)
    v.init_at_time(0.0, p=start[0], v=start[1], q=start[2])
    v.setup_tracker(tparams, cam, frames.shape[-2], frames.shape[-1], seed=0)
    v.enable_health_monitor()

    def run():
        n_applied = 0
        for k in range(frames.shape[0]):
            v.process_imu_batch(times[k][0], seqs[k][0], w_ms[k][0], a_ms[k][0])
            n_applied += v.process_image_measurement(float(times[k][0][-1]), k, frames[k][0])
        return n_applied

    n_applied, ms = _timed(torch, run)
    return v, n_applied, ms


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
    through two collaborating facades, an exchange every
    ``EXCHANGE_EVERY`` frames. Returns (facades, record)."""
    from x_multi_agent_torch.parallel import collab
    from x_multi_agent_torch.vio.vio import VIO

    times, seqs, w_ms, a_ms = imu
    vs = []
    for uav in range(2):
        v = VIO(params, device=device)
        v.init_at_time(0.0, p=start[0][uav], v=start[1][uav], q=start[2][uav])
        v.setup_tracker(tparams, cam, frames.shape[-2], frames.shape[-1], seed=uav)
        v.enable_health_monitor()
        v.enable_collab(words, uav_id=uav, seed=10 + uav)
        vs.append(v)
    payload_b = collab.payload_nbytes(vs[0].get_data_to_send())
    vlad_b = collab.vlad_nbytes(words)
    rec = {"applied": 0, "hits": 0, "fused": 0, "stored": 0, "bytes_rr": 0, "bytes_full": 0}

    def run():
        for k in range(frames.shape[0]):
            for uav, v in enumerate(vs):
                v.process_imu_batch(times[k][uav], seqs[k][uav], w_ms[k][uav], a_ms[k][uav])
                rec["applied"] += v.process_image_measurement(float(times[k][uav][-1]), k,
                                                              frames[k][uav])
            rec["bytes_full"] += 2 * payload_b  # full broadcast: every frame, both ways
            if k % EXCHANGE_EVERY != EXCHANGE_EVERY - 1:
                continue
            for req in range(2):
                res = 1 - req
                payload, found = vs[res].process_other_requests(req, vs[req].get_descriptors())
                rec["bytes_rr"] += vlad_b
                if not found:
                    continue
                rec["hits"] += 1
                rec["bytes_rr"] += payload_b
                slot = int(vs[req]._store.pay_head[0])
                rec["fused"] += vs[req].process_other_measurements(payload, uav_id=res)
                store = vs[req]._store  # rows recorded now point at the slot just written
                rec["stored"] += int(((store.own_id >= 0) & (store.pay_slot == slot)).sum())

    _, rec["ms"] = _timed(torch, run)
    rec["keyframes"] = [v.n_keyframes_selected for v in vs]
    rec["consumed"] = [int(v.n_collab_consumed) for v in vs]
    rec["reinits"] = [v.n_reinits for v in vs]
    rec["payload_bytes"], rec["vlad_bytes"] = payload_b, vlad_b
    return vs, rec


def _launch_calls(prof) -> int:
    """Kernel launches of a ``torch.profiler`` trace, counted on the host
    (the runtime's launch calls; the tracer can drop device events)."""
    return sum(1 for e in prof.events() if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                         "cudaLaunchKernelExC", "cuLaunchKernelEx"))


def run_thermal(torch, params, tparams, cam, raw, clean, imu, start, spatial, device):
    """Degraded frames ``raw`` (n, H, W) uint8 and host IMU windows (numpy,
    (n, L, ...)) through one facade with photometric calibration
    (``spatial`` or global only). Returns (the facade, record)."""
    import warnings

    from x_multi_agent_torch.photometric import calib
    from x_multi_agent_torch.vio.vio import VIO

    times, seqs, w_ms, a_ms = imu
    v = VIO(params, device=device)
    v.init_at_time(0.0, p=start[0], v=start[1], q=start[2])
    v.setup_tracker(tparams, cam, raw.shape[-2], raw.shape[-1], seed=0)
    v.enable_health_monitor()
    v.enable_photometric(n_obs=PHOTO_OBS, spatial=spatial, cell_px=CELL_PX,
                         spatial_every=SPATIAL_EVERY, seed=5)
    update, solve_fn, frame_fn = v._photometric_update, calib.estimate_spatial_parameters, calib.process_frame
    last = {}
    upd_events, gains_before, gains_after = [], [], []

    def timed_update(raw_img):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        update(raw_img)
        ev[1].record()
        upd_events.append(ev)

    def keep_frame(*args, **kwargs):  # the inputs of the last process_frame
        last["frame"] = (args, kwargs)
        return frame_fn(*args, **kwargs)

    def keep_solve(*args, **kwargs):  # the inputs and output of the last solve
        out = solve_fn(*args, **kwargs)
        last["solve"] = (args, kwargs, out)
        return out

    v._photometric_update = timed_update
    calib.process_frame, calib.estimate_spatial_parameters = keep_frame, keep_solve
    try:
        def run():
            n_applied = 0
            for k in range(raw.shape[0]):
                v.process_imu_batch(times[k], seqs[k], w_ms[k], a_ms[k])
                gains_before.append(v.photo.state.current())
                n_applied += v.process_image_measurement(float(times[k][-1]), k, raw[k])
                gains_after.append(v.photo.state.current())
            return n_applied

        n_applied, ms = _timed(torch, run)
    finally:
        calib.process_frame, calib.estimate_spatial_parameters = frame_fn, solve_fn
    n = raw.shape[0]
    rec = {"applied": n_applied, "ms": ms, "reinits": v.n_reinits,
           "update_ms": sum(s.elapsed_time(e) for s, e in upd_events) / n,
           "gains": torch.stack(gains_after).double().cpu(), "last": last,
           "solved": "solve" in last}
    g = torch.stack(gains_before)  # the gains each frame was corrected with
    tail = range(n - 10, n)
    rec["err_corrected"] = float(torch.stack([
        (calib.correct_image(raw[k], g[k, 0], g[k, 1]).double() - clean[k].double()).abs().mean()
        for k in tail]).mean())
    rec["err_raw"] = float(torch.stack([(raw[k].double() - clean[k].double()).abs().mean()
                                        for k in tail]).mean())
    if v.photo.ps is not None:
        rec["map_finite"] = bool(torch.isfinite(v.photo.ps).all())
        rec["map_range"] = [float(v.photo.ps.min()), float(v.photo.ps.max())]

    # 10 further updates on the last frame under the profiler: launches per
    # update, and the synchronizing operations of each (warnings of the
    # sync debug mode)
    from torch.profiler import ProfilerActivity, profile

    syncs = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode(1)
                try:
                    due = (v.photo.frame + 1) % SPATIAL_EVERY == 0 and spatial
                    update(raw[-1])
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs.append((due, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                                if "called a synchronizing" in str(w.message)]))
        torch.cuda.synchronize()
    rec["update_launches"] = _launch_calls(prof) / 10
    rec["syncs"] = syncs
    return v, rec


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
    """Run B's last ``process_frame`` and last spatial solve, re-run through
    the port on the CPU in float64 on the card's inputs: |da|, |db|; the
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
    ``orbit_start``, ``frame_step`` with descriptors and the keyframe step
    for ``N_RC`` frames, rendered here), then ``sharded_collab_round_desc``
    and ``sharded_collab_round``, each timed with CUDA events. Returns the
    block's pre-round states, round outputs, K1/K2 launches, updates
    applied, bytes shipped per collective and ms per round."""
    import torch

    _no_jax()
    from x_multi_agent_torch import configs
    from x_multi_agent_torch.parallel import collab, mesh as pmesh
    from x_multi_agent_torch.place_recognition import database as db_mod
    from x_multi_agent_torch.utils.scene import orbit_dataset, orbit_start
    from x_multi_agent_torch.vio import vio
    from x_multi_agent_torch.vio.frame_step import frame_step
    from x_multi_agent_torch.vision import fast, lk, tracker

    torch.backends.cuda.matmul.allow_tf32 = False
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
    for k in range(N_RC):
        tstate, fs, slots, _, applied = frame_step(
            params, tparams, cam, tstate, fs, slots, frames[k], times[k], seqs[k], w_ms[k],
            a_ms[k], times[k][:, -1], seed=2,
        )
        db, kf_meta, _ = collab.maybe_add_keyframe(params, db_dims, words, fs, slots, db,
                                                   kf_meta, enabled=applied)
        n_applied = n_applied + applied.sum()
    launches = {"fast": fast.K1.launches, "lk": lk.K2.launches}
    desc, ms_desc = _timed(torch, lambda: pmesh.sharded_collab_round_desc(
        params, ccfg, words, mesh)(fs, slots, db))
    full, ms_full = _timed(torch, lambda: pmesh.sharded_collab_round(params, ccfg, mesh)(desc[0]))
    _no_jax()
    return {"pre": (fs, slots, db), "desc": desc, "full": full, "launches": launches,
            "applied": int(n_applied), "shipped": dict(mesh.shipped),
            "ms": {"desc": ms_desc, "full": ms_full}}


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
    gloo ranks on the one card run phase 7's fleet in blocks
    (:func:`exchange_rank`), and the single-process rounds on their
    gathered pre-round states, with the same keyed draws, are held against
    theirs; 10b: the sharded rounds in this process at NCCL world size 1
    against the single-process rounds, bit for bit; 10c: the dry run on
    ``N_RANKS`` gloo ranks of 2 agents. Returns the record."""
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
            {k: r[k] for k in ("launches", "applied", "shipped", "ms")} for r in ranks]}

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

        mesh = pmesh.make_agent_mesh("nccl", f"file://{tmp}/nccl", 0, 1, device)
        try:
            nccl = dryrun.sharded_rounds(mesh, params, fs, ccfg, ccfg, words, slots, db)
            torch.cuda.synchronize()
        finally:
            torch.distributed.destroy_process_group()
        rec["nccl"] = {key: tree_diff(torch, nccl[key], ref[key], key) for key in nccl}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["dryrun"] = dryrun.dryrun_multichip(N_RANKS, "gloo", 2, device="cuda")
    rec["seconds"] = time.perf_counter() - t0
    return rec


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
    from x_multi_agent_torch.utils.scene import orbit_dataset, orbit_start
    from x_multi_agent_torch.vio import vio
    from x_multi_agent_torch.vio.frame_step import frame_step
    from x_multi_agent_torch.vision import fast, lk, tracker

    # ---- 0. card and build -------------------------------------------------
    card = _card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
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
            good = (stt["ok_agree"] >= 0.995 and stt["max_disagree_margin"] <= 1e-3
                    and stt["max_flow_err"] <= 2e-2 and stt["share_within_1e-3"] >= 0.99
                    and stt["n_both_ok"] > 0)
            if not good:
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
              f"{r['device_ms']:.4f} ms (profiler), events {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{r['bytes_per_frame']} bytes, {r['ops_per_frame']} operations per frame), "
              f"share of bound {r['share_of_bound']:.3f} ({card})")

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
            torch, params, tparams, cam, frames[:N_FACADE, :1], host_imu, (p0[0], v0[0], q0[0]),
            dev)
    finally:
        fast.fast_score_nms = dispatch
    launches = counts.read()
    print(f"facade: 1 agent x {N_FACADE} frames: {elapsed_ms / N_FACADE:.3f} ms/frame; updates "
          f"applied {n_applied}/{N_FACADE}; re-inits {v.n_reinits}; K1 shapes "
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
          f"{fp['ms'] / N_FACADE:.3f} ms per frame of the pair "
          f"({fp['ms'] / (2 * N_FACADE):.3f} ms per agent-frame); updates applied "
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
    host_imu = tuple(x[:N_FACADE, 0].cpu().numpy() for x in imu)
    thermal = {}
    for name, spatial in (("A", False), ("B", True)):
        shapes.clear()
        fast.fast_score_nms = watch
        counts.start()
        try:
            v, tr = run_thermal(torch, params, tparams, cam, raw, clean, host_imu,
                                (p0[0], v0[0], q0[0]), spatial, dev)
        finally:
            fast.fast_score_nms = dispatch
        launches = counts.read()
        thermal[name] = tr
        g = tr["gains"]
        at = {f: [round(float(g[f - 1, 0]), 6), round(float(g[f - 1, 1]), 6)] for f in (10, 20, 30)}
        print(f"thermal facade run {name} (spatial {spatial}): 1 agent x {N_FACADE} frames: "
              f"{tr['ms'] / N_FACADE:.3f} ms/frame (phase 6: {elapsed_ms / N_FACADE:.3f}); "
              f"photometric update {tr['update_ms']:.3f} ms/frame, {tr['update_launches']:.1f} "
              f"launches per update; updates applied {tr['applied']}/{N_FACADE}; re-inits "
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
    cmp = photo_card_vs_cpu(torch, thermal["B"]["last"])
    print(f"thermal card vs CPU float64 (run B's last inputs): |da| {cmp['da']:.3g}, |db| "
          f"{cmp['db']:.3g}, centred map max diff {cmp['map_centred_err']:.3g} (map scale "
          f"{cmp['map_scale']:.3g}), mean offset {cmp['map_offset']:.3g}; cells per connected "
          f"component {cmp['components']}, their offsets {cmp['component_offsets']}, map max diff "
          f"with those offsets removed {cmp['map_err_per_component']:.3g} ({card})")
    if cmp["da"] > 1e-4 or cmp["db"] > 1e-4 or cmp["map_err_per_component"] > 1e-3:
        raise AssertionError(f"thermal facade: the card's calibration disagrees with the CPU's: {cmp}")
    _no_jax()

    # ---- 10. the multi-rank exchange -------------------------------------------
    ex = run_exchange(torch, params, words, dev)
    for i, r in enumerate(ex["ranks"]):
        for name in counts.total:
            counts.total[name] += r["launches"][name]
        print(f"exchange rank {i}: {N_AGENTS // N_RANKS} agents x {N_RC} frames, updates applied "
              f"{r['applied']}/{N_AGENTS // N_RANKS * N_RC}; descriptor round "
              f"{r['ms']['desc']:.3f} ms, full-map round {r['ms']['full']:.3f} ms; bytes shipped "
              f"{r['shipped']}; launches K1 {r['launches']['fast']} K2 {r['launches']['lk']} ({card})")
    print(f"exchange: {N_RANKS} gloo ranks on one card, {ex['ranks_s']:.2f} s for the ranks; "
          f"hits {ex['hits']}, matches fused {ex['desc_fused']} (descriptor round) and "
          f"{ex['full_fused']} (full-map round); single-process rounds {ex['single_ms']:.3f} ms; "
          f"against them: gloo {json.dumps(ex['gloo'])}; NCCL world size 1 "
          f"{json.dumps(ex['nccl'])} ({card})")
    dry = ex["dryrun"]
    print(f"exchange dry run: {dry['agents']} agents on {dry['ranks']} gloo ranks: fused "
          f"{dry['matches_fused']} + {dry['desc_fused']}, hits {dry['hits']}, bytes gated "
          f"{dry['bytes_gated']} vs full {dry['bytes_full']}, shipped {dry['shipped']}, checks "
          f"{dry['checks']} ({card})")
    print(f"phase 10: {ex['seconds']:.2f} s wall ({card})")
    applied = sum(r["applied"] for r in ex["ranks"])
    if applied < 0.9 * N_AGENTS * N_RC or not ex["finite"]:
        raise AssertionError(f"exchange: {applied} updates applied, covariance finite {ex['finite']}")
    if any(r["launches"]["fast"] < 1 or r["launches"]["lk"] < 3 * N_RC for r in ex["ranks"]):
        raise AssertionError(f"exchange: a rank missed a kernel: {ex['ranks']}")
    if ex["hits"] < 1 or ex["desc_fused"] < 1 or ex["full_fused"] < 1:
        raise AssertionError("exchange: no hit or no fused match")
    for key, d in ex["gloo"].items():
        if d["int_differ"] or not d["worst_rel"] <= 1e-4:
            raise AssertionError(f"exchange: the {key} round on the ranks differs: {d}")
    for key, d in ex["nccl"].items():
        if not d["bitwise"]:
            raise AssertionError(f"exchange: the {key} round at NCCL world size 1 differs: {d}")
    _no_jax()

    kernels = []
    for name, k in (("fast", fast.K1), ("lk", lk.K2)):
        r = records[name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": counts.total[name], "max_abs_err": r["max_abs_err"],
            **{key: r[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                       "share_of_bound", "launches_per_frame", "library_ms")},
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
