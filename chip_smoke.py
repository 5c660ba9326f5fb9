#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``x_multi_agent_torch``) on one
NVIDIA card: the quickest proof that the port starts and is right there.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  0. card and build: print the card's name and power limit, require CUDA,
     turn TF32 off, build the CUDA kernels from ``x_multi_agent_torch/csrc``;
  1. K1 (FAST score + NMS) against its plain version on rendered frames at
     the slice's detection shapes (16x480x640 and 16x240x320): exact;
  2. K2 (one LK level) against its plain version at the slice's three
     pyramid levels, 16 agents x 200 features, half_win 10, and once at
     half_win 15: ok flags agree on >= 99.5 % (disagreements only at the
     min-eigenvalue gate), |dflow| <= 2e-2 px where both are ok, >= 99 %
     within 1e-3 px;
  3. the slice: 16 agents x 30 frames of 480x640 (pre-rendered, not timed)
     through ``frame_step`` at the flagship dims: 10 warm-up frames, 20
     frames timed with CUDA events; the image benchmark's asserts (live
     features >= 10 per agent, finite covariance), both kernels launched on
     the main path, no JAX imported;
  4. times of K1 and K2 against their plain versions at the slice shapes.

The last three lines of standard output are the kernels' JSON record, the
card's ``nvidia-smi`` name and power limit, and the result JSON.
"""
import json
import os
import subprocess
import sys
import time

N_AGENTS, H, W = 16, 480, 640
N_WARM, N_TIMED = 10, 20


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    from x_multi_agent_torch.utils.scene import orbit_dataset
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

    # ---- 1. K1 against its plain version -----------------------------------
    pyr0 = build_pyramid(frames[0], tparams.lk_max_level)
    det_levels = [pyr0[l].contiguous() for l in range(tparams.pyramid_depth)]
    k1_err = 0.0
    for img in det_levels:
        got = fast.fast_score_nms(img, tparams.fast_threshold, nms=True)
        ref = fast.nms3(fast.fast_score(img, tparams.fast_threshold))
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        print(f"K1 {tuple(img.shape)}: max |kernel - plain| = {err}, corners = {int((ref > 0).sum())}")
        if err != 0.0:  # subtract/min/max/compare only: bit-exact
            raise AssertionError("K1 differs from its plain version")
        k1_err = max(k1_err, err)
    records["fast"] = {"max_abs_err": k1_err}

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

    # ---- 3. the slice --------------------------------------------------------
    fs, slots = vio.init_at_time(params, 0.0, N_AGENTS, dev)
    tstate = tracker.TrackerState.zero(tparams, N_AGENTS, H, W, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    times, seqs, w_ms, a_ms = imu
    n_applied = torch.zeros((), dtype=torch.int64, device=dev)
    fast.K1.launches = 0
    lk.K2.launches = 0
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
    launches = {"fast": fast.K1.launches, "lk": lk.K2.launches}
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
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

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

    kernels = []
    for name, k in (("fast", fast.K1), ("lk", lk.K2)):
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[name], "max_abs_err": records[name]["max_abs_err"],
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
