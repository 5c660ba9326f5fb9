#!/usr/bin/env python3
"""CPU rehearsal of the thermal facade run of ``chip_smoke.py`` (phase 9), at
a reduced frame size, through both packages.

    python3 scripts/thermal_rehearsal.py [--h 120] [--w 160] [--frames 30] [--out F]

Agent 0's orbit frames of the smoke (``utils/scene.orbit_dataset``, the
textured wall, 20 Hz camera, 200 Hz IMU) are degraded as phase 9 degrades
them (``scene.degrade_frames``: a = 1 + 0.01 k, b = 0.002 k, vignette 0.06,
noise 0.006, torch generator seed 9, uint8) and fed with their IMU to the
reference's ``VIO`` facade (JAX, float32) and to the port's (CPU, float32),
each started at the orbit's initial state with the health monitor on and
``enable_photometric(n_obs=80)`` (global gains only, the accuracy report's
setting). Per facade: updates applied, re-inits, the gains before frames
10, 20 and 30 against the baked ones and the gains that undo them, and over
the last 10 frames the mean |corrected - clean| and |raw - clean| in gray
levels, where "corrected" is the image the tracker saw (``correct_image``
with the gains of the frame before) and "clean" the undegraded render.
Prints one JSON object (and writes it to ``--out``). Needs JAX; runs on
the CPU only.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from x_multi_agent_tpu.photometric import calib as jcal  # noqa: E402
from x_multi_agent_tpu.vio import vio as jvio  # noqa: E402
from x_multi_agent_tpu.vision import camera as jcam  # noqa: E402
from x_multi_agent_tpu.vision import tracker as jtrk  # noqa: E402
from x_multi_agent_torch import configs  # noqa: E402
from x_multi_agent_torch.photometric import calib as tcal  # noqa: E402
from x_multi_agent_torch.utils import scene  # noqa: E402
from x_multi_agent_torch.vio import vio as tvio  # noqa: E402

GAINS = [(1.0 + 0.01 * k, 0.002 * k) for k in range(1000)]
VIGNETTE, NOISE, SEED = 0.06, 0.006, 9


def inverse_gains(a, b):
    """The gains that undo (a, b): correcting x (a - b) + b with them gives
    x back."""
    return (1.0 - b) / (a - b), -b / (a - b)


def run(facade, gains_of, correct, frames_u8, clean, imu, start):
    """Drive one facade; returns its record."""
    times, seqs, w_ms, a_ms = imu
    facade.init_at_time(0.0, p=start[0], v=start[1], q=start[2])
    facade.enable_health_monitor()
    facade.enable_photometric(n_obs=80)
    n = frames_u8.shape[0]
    applied, gains, err_c, err_r = 0, [], [], []
    for k in range(n):
        facade.process_imu_batch(times[k], seqs[k], w_ms[k], a_ms[k])
        a, b = gains_of(facade)
        gains.append((a, b))
        if k >= n - 10:
            corr = correct(frames_u8[k], a, b)
            err_c.append(float(np.abs(corr - clean[k]).mean()))
            err_r.append(float(np.abs(frames_u8[k].astype(np.float64) - clean[k]).mean()))
        applied += bool(facade.process_image_measurement(float(times[k][-1]), k, frames_u8[k]))
    return {
        "applied": applied, "frames": n, "reinits": facade.n_reinits,
        "gains_before_frame": {str(f): [gains[f - 1][0], gains[f - 1][1]] for f in (10, 20, 30)
                               if f <= n},
        "baked_at_frame": {str(f): list(GAINS[f - 1]) for f in (10, 20, 30) if f <= n},
        "inverse_of_baked": {str(f): list(inverse_gains(*GAINS[f - 1])) for f in (10, 20, 30)
                             if f <= n},
        "mean_abs_corrected_minus_clean": float(np.mean(err_c)),
        "mean_abs_raw_minus_clean": float(np.mean(err_r)),
        "finite_tail": bool(np.isfinite(np.asarray(facade.tail_state().p, dtype=np.float64)).all()),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=120)
    ap.add_argument("--w", type=int, default=160)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out")
    args = ap.parse_args()
    h, w, n = args.h, args.w, args.frames
    torch.set_num_threads(2)

    frames, imu = scene.orbit_dataset(1, n, h, w, "cpu")
    clean = frames[:, 0].double().numpy()
    gen = torch.Generator().manual_seed(SEED)
    frames_u8 = scene.degrade_frames(frames[:, 0], GAINS[:n], VIGNETTE, NOISE, gen).numpy()
    imu = tuple(x[:, 0].numpy() for x in imu)
    p0, v0, q0 = scene.orbit_start(1)
    start = (p0[0], v0[0], q0[0])
    tparams = configs.flagship_tracker(200)
    cam = configs.flagship_camera(h, w)

    jv = jvio.VIO(ge._params())
    jv.setup_tracker(jtrk.TrackerParams(**tparams._asdict()), jcam.Camera(*cam), h, w)

    def jax_gains(v):
        st = v.__dict__.get("_photo_state")
        if st is None:
            return 1.0, 0.0
        pt = np.asarray(st.params_pt[st.frame_ptr], np.float64)
        return float(pt[0]), float(pt[1])

    def jax_correct(img, a, b):
        return np.asarray(jcal.correct_image(jnp.asarray(img), jnp.float32(a), jnp.float32(b)),
                          np.float64)

    tv = tvio.VIO(configs.flagship_params(), device="cpu")
    tv.setup_tracker(tparams, cam, h, w, seed=0)

    def port_gains(v):
        if v.photo is None:
            return 1.0, 0.0
        a, b = v.photo.state.current().double().tolist()
        return a, b

    def port_correct(img, a, b):
        return tcal.correct_image(torch.from_numpy(img), torch.tensor(a, dtype=torch.float32),
                                  torch.tensor(b, dtype=torch.float32)).double().numpy()

    out = {"h": h, "w": w, "frames": n, "vignette": VIGNETTE, "noise": NOISE}
    out["jax"] = run(jv, jax_gains, jax_correct, frames_u8, clean, imu, start)
    out["port"] = run(tv, port_gains, port_correct, frames_u8, clean, imu, start)
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
