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
  4. times of K1 and K2 against their plain versions at the slice shapes;
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
     a fused match, K1 on a (1, 480, 640) frame and K2 launched.

The last three lines of standard output are the kernels' JSON record (the
launch counts summed over the paths of phases 3 and 5-8, each read from 0
around its path), the card's ``nvidia-smi`` name and power limit, and the
result JSON.
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
    gen = torch.Generator(device=device).manual_seed(1)
    times, seqs, w_ms, a_ms = imu
    rounds = []
    for k in range(n_frames):
        tstate, fs, slots, _, _ = frame_step(
            params, tparams, cam, tstate, fs, slots, frames[k], times[k], seqs[k],
            w_ms[k], a_ms[k], times[k][:, -1], generator=gen,
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
    v.setup_tracker(tparams, cam, frames.shape[-2], frames.shape[-1], generator=0)
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
    from x_multi_agent_torch.ops.ransac import generator_sampler
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
    gen = torch.Generator(device=device).manual_seed(2)
    sampler = generator_sampler(torch.Generator(device=device).manual_seed(7))
    db_dims = db_mod.DbDims(n_keyframes=15, n_words=N_WORDS, max_agents=a)
    times, seqs, w_ms, a_ms = imu
    n_sel = torch.zeros((a,), dtype=torch.int64, device=device)
    rec = {"rounds": []}
    for k in range(N_RC):
        tstate, fs, slots, _, applied = frame_step(
            params, tparams, cam, tstate, fs, slots, frames[k], times[k], seqs[k],
            w_ms[k], a_ms[k], times[k][:, -1], generator=gen,
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
                params, ccfg, words, fs, slots, db, sampler=sampler))
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
        v.setup_tracker(tparams, cam, frames.shape[-2], frames.shape[-1], generator=uav)
        v.enable_health_monitor()
        v.enable_collab(words, uav_id=uav, generator=10 + uav)
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
    from x_multi_agent_torch.vision.image import build_pyramid, scharr_gradients

    # ---- 0. card and build -------------------------------------------------
    card = _card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    native.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {native.build_seconds} s)")

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
    pyr0 = build_pyramid(frames[0], tparams.lk_max_level)
    det_levels = [pyr0[l].contiguous() for l in range(tparams.pyramid_depth)]
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
    st = tracker.TrackerState.zero(tparams, N_AGENTS, H, W, device=dev)
    cand = tracker._detect_new_batch(tparams, pyr0, st.pts, st.ids >= 0)
    st = tracker._integrate(tparams, st, frames[0], st.ids >= 0, st.pts, *cand)
    pts = st.pts.contiguous()
    print(f"K2 inputs: {int((st.ids >= 0).sum())} features over {N_AGENTS} agents")
    pyr1 = build_pyramid(frames[1], tparams.lk_max_level)
    k2_err = 0.0
    level_inputs = []
    for half_win in (tparams.win_half, 15):
        flow = torch.zeros_like(pts)
        for lvl in range(len(pyr0) - 1, -1, -1):
            dx, dy = scharr_gradients(pyr0[lvl])
            pts_l = (pts / 2.0**lvl).contiguous()
            flow = (flow * 2.0 if lvl < len(pyr0) - 1 else flow).contiguous()
            args = (pyr0[lvl].contiguous(), pyr1[lvl].contiguous(), dx.contiguous(),
                    dy.contiguous(), pts_l, flow, half_win, tparams.lk_iters,
                    tparams.min_eig_thr)
            f_k, ok_k = lk.track_level(*args)
            f_p, ok_p = lk._track_level(*args)
            torch.cuda.synchronize()
            margin = lk.gate_margin(dx, dy, pts_l, half_win, tparams.min_eig_thr)
            stt = lk.level_agreement(f_p, ok_p, f_k, ok_k, margin)
            print(f"K2 half_win={half_win} level {lvl} {tuple(pyr0[lvl].shape)}: {json.dumps(stt)}")
            good = (stt["ok_agree"] >= 0.995 and stt["max_disagree_margin"] <= 1e-3
                    and stt["max_flow_err"] <= 2e-2 and stt["share_within_1e-3"] >= 0.99
                    and stt["n_both_ok"] > 0)
            if not good:
                raise AssertionError(f"K2 differs from its plain version at level {lvl}")
            k2_err = max(k2_err, stt["max_flow_err"])
            if half_win == tparams.win_half:
                level_inputs.append(args)
            flow = f_p
    records["lk"] = {"max_abs_err": k2_err}

    _no_jax()

    # ---- 3. the slice --------------------------------------------------------
    p0, v0, q0 = orbit_start(N_AGENTS)
    fs, slots = vio.init_at_time(params, 0.0, N_AGENTS, dev, p=p0, v=v0, q=q0)
    tstate = tracker.TrackerState.zero(tparams, N_AGENTS, H, W, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
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
            w_ms[k], a_ms[k], times[k][:, -1], generator=gen,
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

    # ---- 4. kernel vs plain times at the slice shapes -----------------------
    thr = tparams.fast_threshold
    records["fast"]["ms"] = _ms(torch, lambda: [fast.fast_score_nms(i, thr) for i in det_levels])
    records["fast"]["plain_ms"] = _ms(
        torch, lambda: [fast.nms3(fast.fast_score(i, thr)) for i in det_levels])
    records["lk"]["ms"] = _ms(torch, lambda: [lk.track_level(*a) for a in level_inputs])
    records["lk"]["plain_ms"] = _ms(torch, lambda: [lk._track_level(*a) for a in level_inputs])
    for name, r in records.items():
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
              f"(one frame's levels, {card})")

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

    kernels = []
    for name, k in (("fast", fast.K1), ("lk", lk.K2)):
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": counts.total[name], "max_abs_err": records[name]["max_abs_err"],
            "ms": records[name]["ms"], "plain_ms": records[name]["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
