"""The image-driven frame step for a batch of agents: the tracker, then the
per-agent filter step (IMU batch, then the match-driven visual update).

This is the composition the reference's image benchmark times per frame
(``tracker.track_frame_batch`` followed by ``ekf.process_imu_batch_impl``
and ``ekf.process_update_aux_impl`` over ``pipeline.visual_update``); it
adds no behaviour of its own. :func:`frame_step` runs it eagerly;
:class:`CompiledFrameStep` runs the compiled tracker and the compiled filter
step, what the reference's ``bench.py`` scan body is per frame.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ekf import ekf as ekf_mod
from ..ops import linalg
from ..parallel.mesh import agent_step_fn
from ..vision import camera as cam_mod
from ..vision import tracker as trk
from . import pipeline
from .vio import VioParams


def frame_step(
    params: VioParams,
    tparams: trk.TrackerParams,
    cam: cam_mod.Camera,
    tstate: trk.TrackerState,
    fs,
    slots,
    imgs: torch.Tensor,  # (A, H, W) frame
    times: torch.Tensor,  # (A, L) IMU samples since the last frame
    seqs: torch.Tensor,  # (A, L)
    w_ms: torch.Tensor,  # (A, L, 3)
    a_ms: torch.Tensor,  # (A, L, 3)
    meas_time: torch.Tensor,  # (A,) frame time
    seed: int = 0,
    ransac_idx: Optional[torch.Tensor] = None,
):
    """One frame for every agent. Returns (tstate, fs, slots, matches,
    applied (A,)). The tracker's RANSAC draws are keyed on (``seed``, each
    agent's ``next_id``) unless ``ransac_idx`` gives them.

    On CUDA tensors the filter algebra must run in full fp32: raises if
    TF32 matmuls are on (``torch.backends.cuda.matmul.allow_tf32``). The
    step runs no cuDNN operation, so the cuDNN flag does not matter here."""
    linalg.require_fp32_matmul(imgs.device, "frame_step")
    tstate, matches = trk.track_frame_batch(
        tparams, cam, tstate, imgs, seed=seed, ransac_idx=ransac_idx
    )
    meas = pipeline.FrameMeasurement.from_matches(params.cfg, matches)
    ekf_p = params.ekf_params
    fs = ekf_mod.process_imu_batch_impl(ekf_p, fs, times, seqs, w_ms, a_ms)

    def update_fn(core, vision, cov, slots):
        return pipeline.visual_update(params.cfg, core, vision, cov, slots, meas)

    fs, slots, applied = ekf_mod.process_update_aux_impl(ekf_p, fs, meas_time, update_fn, slots)
    return tstate, fs, slots, matches, applied


class CompiledFrameStep:
    """:func:`frame_step` as compiled programs (``utils/graph.py``): the
    tracker's three graphs around its detection gate
    (:class:`tracker.TrackerProgram`), then the filter step's graph
    (``mesh.agent_step_fn``). Same arguments and results as
    :func:`frame_step` without the static ones; the returned state,
    matches and ``applied`` are the programs' buffers, valid until the next
    call. ``graphs`` are the programs' graph sets (capture cost, replayed
    device work)."""

    def __init__(self, params: VioParams, tparams: trk.TrackerParams, cam: cam_mod.Camera,
                 seed: int = 0):
        self.params, self.seed = params, seed
        self.tracker = trk.TrackerProgram(tparams, cam)
        self.step = agent_step_fn(params)
        self.graphs = (self.tracker.graphs, self.step.graphs)

    def __call__(self, tstate, fs, slots, imgs, times, seqs, w_ms, a_ms, meas_time,
                 ransac_idx: Optional[torch.Tensor] = None):
        tstate, matches = self.tracker(tstate, imgs, self.seed, ransac_idx)
        meas = pipeline.FrameMeasurement.from_matches(self.params.cfg, matches)
        fs, slots, applied = self.step(fs, slots, times, seqs, w_ms, a_ms, meas_time, meas)
        return tstate, fs, slots, matches, applied
