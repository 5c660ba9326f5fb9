#!/usr/bin/env python3
"""Where the time of the port's image-driven frame step goes, on one card.

    python3 scripts/profile_torch_slice.py [--out F]

Runs the flagship slice of ``chip_smoke.py`` (16 agents, 480x640 frames,
flagship dims, each agent started at its orbit's initial state) and reports, per frame: the CUDA-event time of its three stages
(tracker, IMU batch, visual update), and from a ``torch.profiler`` trace of
a few frames the device-busy time (sum of kernel times), the device idle
share of the wall time and the number of kernel launches, with the top
kernels by device time; then the same trace of one collaborative round
(``collab.collaborative_round``, default ``CollabConfig``) of those 16
agents, and of the request-response collaboration's calls on their state:
the visual update alone and with the match store
(``collab.visual_update_with_store``), the keyframe step
(``collab.maybe_add_keyframe``), one ``request_response_round`` and one
``collaborative_msckf_round``. Every collaboration call computes its masked
work whatever the data, so its launches and host time do not depend on
there being keyframes, hits or stored matches. Prints the JSON (and writes
it to ``--out`` when given). Needs a CUDA card.
"""
import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from x_multi_agent_torch import configs  # noqa: E402
from x_multi_agent_torch.ekf import ekf as ekf_mod  # noqa: E402
from x_multi_agent_torch.parallel import collab, match_store  # noqa: E402
from x_multi_agent_torch.place_recognition import database as db_mod  # noqa: E402
from x_multi_agent_torch.utils.scene import orbit_dataset, orbit_start  # noqa: E402
from x_multi_agent_torch.vio import pipeline, vio  # noqa: E402
from x_multi_agent_torch.vision import tracker  # noqa: E402

H, W = 480, 640
AGENTS = 16
WARM = 8  # warm-up frames
FRAMES = 16  # frames timed with CUDA events
TRACED = 3  # frames under the profiler


def _device_us(event) -> float:
    """Device time of one profiler event (the attribute was renamed across
    torch versions)."""
    for attr in ("device_time", "cuda_time", "self_device_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    raise AttributeError("profiler event has no device time")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    a = AGENTS
    n = WARM + FRAMES + TRACED
    frames, (times, seqs, w_ms, a_ms) = orbit_dataset(a, n, H, W, dev)
    params = configs.flagship_params()
    tparams = configs.flagship_tracker(params.cfg.tracks.n_matches)
    cam = configs.flagship_camera(H, W)
    p0, v0, q0 = orbit_start(a)
    fs, slots = vio.init_at_time(params, 0.0, a, dev, p=p0, v=v0, q=q0)
    tstate = tracker.TrackerState.zero(tparams, a, H, W, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ekf_p = params.ekf_params
    stages = ("tracker", "imu", "update")
    sums = dict.fromkeys(stages, 0.0)

    meas = None

    def step(k, timed):
        nonlocal tstate, fs, slots, meas
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        tstate, matches = tracker.track_frame_batch(tparams, cam, tstate, frames[k])
        ev[1].record()
        fs = ekf_mod.process_imu_batch_impl(ekf_p, fs, times[k], seqs[k], w_ms[k], a_ms[k])
        ev[2].record()
        meas = pipeline.FrameMeasurement.from_matches(params.cfg, matches)
        fs, slots, _ = ekf_mod.process_update_aux_impl(
            ekf_p, fs, times[k][:, -1],
            lambda c, v, p, s: pipeline.visual_update(params.cfg, c, v, p, s, meas), slots,
        )
        ev[3].record()
        if timed:
            torch.cuda.synchronize()
            for i, s in enumerate(stages):
                sums[s] += ev[i].elapsed_time(ev[i + 1])

    for k in range(WARM):
        step(k, False)
    for k in range(WARM, WARM + FRAMES):
        step(k, True)

    def traced(fn, reps):
        """Wall ms, device-busy ms and launches per call of ``fn`` under the
        profiler, and the top kernels by device ms per call."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + _device_us(e) / 1e3
        busy_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        return {
            "wall_ms": wall_ms / reps, "device_busy_ms": busy_ms / reps,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": len(kernels) / reps,
            "top_kernels_ms": {k: v / reps for k, v in top},
        }

    from torch.profiler import ProfilerActivity, profile

    frame = traced(lambda i: step(WARM + FRAMES + i, False), TRACED)
    ccfg = collab.CollabConfig()
    collab.collaborative_round(params, ccfg, fs)  # warm-up
    fused = []
    rnd = traced(lambda i: fused.append(int(collab.collaborative_round(params, ccfg, fs)[1].sum())), 1)
    rnd["matches_fused"] = fused[0]

    t_meas = times[n - 1][:, -1]
    store = match_store.MatchStore.zero(params.cfg.dims, match_store.StoreDims(), a, device=dev)
    db_dims = db_mod.DbDims(n_keyframes=15, n_words=64, max_agents=a)
    words = torch.randint(0, 256, (64, 32), generator=gen, device=dev).to(torch.uint8)
    db = db_mod.KeyframeDB.zero(db_dims, collab.extract_payload_desc(params, fs, slots))
    kf_meta = collab.KfMeta.zero(a, fs.cov.dtype, dev)
    calls = {
        "visual_update": lambda i: ekf_mod.process_update_aux_impl(
            ekf_p, fs, t_meas,
            lambda c, v, p, s: pipeline.visual_update(params.cfg, c, v, p, s, meas), slots),
        "visual_update_with_store": lambda i: collab.visual_update_with_store(
            params, ccfg, fs, slots, store, t_meas, meas),
        "keyframe_step": lambda i: collab.maybe_add_keyframe(
            params, db_dims, words, fs, slots, db, kf_meta),
        "request_response_round": lambda i: collab.request_response_round(
            params, ccfg, words, fs, slots, db),
        "msckf_round": lambda i: collab.collaborative_msckf_round(params, ccfg, fs, slots),
    }
    request_comm = {}
    for name, fn in calls.items():
        fn(0)  # warm-up
        request_comm[name] = traced(fn, 1)
    out = {
        "card": torch.cuda.get_device_name(0),
        "agents": a,
        "frame_ms": {s: sums[s] / FRAMES for s in stages},
        "traced_frames": TRACED,
        "traced_wall_ms_per_frame": frame["wall_ms"],
        "device_busy_ms_per_frame": frame["device_busy_ms"],
        "device_idle_share": frame["device_idle_share"],
        "kernel_launches_per_frame": frame["kernel_launches"],
        "top_kernels_ms_per_frame": frame["top_kernels_ms"],
        "collab_round": rnd,
        "request_comm": request_comm,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
