"""PyTorch port vs the JAX reference: the image-driven frame step as a whole.

The port's ``frame_step`` (tracker, then IMU batch + visual update per agent)
against the composition the reference's image benchmark runs per frame
(``bench.py``, ``bench_image``: ``track_frame_batch`` then the vmapped
``_filter_step``), over 4 frames of 2 agents at the small test dims with a
24-feature tracker budget on 120x160 frames rendered with numpy. RANSAC gets
the reference's own hypothesis draws.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as ge
import bench
from torch_helpers import (CPU, assert_tree_close, jax_frame_indices, np_tree, orbit_frames,
                           stack, t, to_port)
from x_multi_agent_tpu.vio import vio as jvio
from x_multi_agent_tpu.vision import camera as jcam
from x_multi_agent_tpu.vision import tracker as jtrk
from x_multi_agent_torch import configs
from x_multi_agent_torch.vio import vio as tvio
from x_multi_agent_torch.vio.frame_step import frame_step
from x_multi_agent_torch.vision import tracker as ttrk

A, H, W, N_FRAMES = 2, 120, 160, 4


def test_frame_step_matches_reference_composition():
    jp = ge._params(small=True)._replace(dtype="float64")
    tp = configs.flagship_params(small=True)._replace(dtype="float64")
    j = jp.cfg.tracks.n_matches
    trk_p = configs.flagship_tracker(j)
    jtrk_p = jtrk.TrackerParams(**trk_p._asdict())
    cam = configs.flagship_camera(H, W)
    jc = jcam.Camera(*cam)
    frames, imu = orbit_frames(A, N_FRAMES, H, W)

    fs, slots = jvio.init_at_time(jp, 0.0)
    fs, slots = stack(fs, A), stack(slots, A)
    tstate = stack(jtrk.TrackerState.zero(jtrk_p, H, W, jnp.float64), A)
    p_fs, p_slots, p_tstate = to_port(fs), to_port(slots), to_port(tstate)
    one_agent = bench._filter_step(jp)

    @jax.jit
    def ref_step(tstate, fs, slots, imgs, times, seqs, w_, a_):
        tstate, matches = jtrk.track_frame_batch(jtrk_p, jc, tstate, imgs)
        fs, slots, applied = jax.vmap(one_agent)(
            fs, slots, times, seqs, w_, a_, times[:, -1], matches
        )
        return tstate, fs, slots, matches, applied

    for k in range(N_FRAMES):
        x = [v[k] for v in imu]
        idx = jax_frame_indices(jtrk_p, tstate, jnp.asarray(frames[k]))
        tstate, fs, slots, m, app = ref_step(
            tstate, fs, slots, jnp.asarray(frames[k]), *map(jnp.asarray, x)
        )
        p_tstate, p_fs, p_slots, p_m, p_app = frame_step(
            tp, trk_p, cam, p_tstate, p_fs, p_slots, t(frames[k]), *map(t, x),
            t(x[0][:, -1]), ransac_idx=t(idx),
        )
        # integer / boolean leaves (applied, ids, slot ids, masks,
        # n_valid_features) exactly; float leaves to 1e-8 of each leaf's max:
        # the two packages sum in different orders and the reference solves
        # SPD systems by Newton-Schulz iteration where the port uses Cholesky,
        # float64 rounding that the filter carries over 4 frames
        np.testing.assert_array_equal(p_app.numpy(), np.asarray(app))
        assert_tree_close(p_m, np_tree(m), 1e-8, "matches")
        assert_tree_close(p_tstate, np_tree(tstate), 1e-8, "tracker")
        assert_tree_close(p_slots, np_tree(slots), 1e-8, "slots")
        assert_tree_close(p_fs, np_tree(fs), 1e-8, "filter")
    assert bool(np.asarray(app).all()) and int(np.asarray(m.valid).sum()) > 10


def test_frame_step_generator_path_runs_in_float32():
    """The card's configuration on the CPU: float32, RANSAC hypotheses keyed
    on a seed and the tracker state; deterministic for a seed, finite
    covariance."""
    tp = configs.flagship_params(small=True)
    trk_p = configs.flagship_tracker(tp.cfg.tracks.n_matches)
    cam = configs.flagship_camera(H, W)
    frames, imu = orbit_frames(A, 3, H, W)
    outs = []
    for _ in range(2):
        fs, slots = tvio.init_at_time(tp, 0.0, A, CPU)
        tstate = ttrk.TrackerState.zero(trk_p, A, H, W, device=CPU)
        for k in range(3):
            x = [t(v[k], torch.float32) for v in imu]
            tstate, fs, slots, m, app = frame_step(
                tp, trk_p, cam, tstate, fs, slots, t(frames[k], torch.float32), *x,
                x[0][:, -1], seed=0,
            )
        outs.append((fs.cov, tstate.ids, m.valid))
    assert bool(app.all()) and bool(torch.isfinite(outs[0][0]).all())
    for a_, b_ in zip(*outs):
        assert torch.equal(a_, b_)


def test_port_never_imports_jax():
    code = (
        "import sys, torch\n"
        "from x_multi_agent_torch import configs\n"
        "from x_multi_agent_torch.vio import frame_step, vio\n"
        "from x_multi_agent_torch.vision import tracker\n"
        "from x_multi_agent_torch.utils import collab_eval, convert\n"
        "from x_multi_agent_torch.parallel import collab\n"
        "from x_multi_agent_torch.vio.updates import range, solar\n"
        "p = configs.flagship_params(small=True)\n"
        "fs, slots = vio.init_at_time(p, 0.0, 2, torch.device('cpu'))\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr

