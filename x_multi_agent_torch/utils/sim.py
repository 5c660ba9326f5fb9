"""Synthetic trajectory + landmark simulator (the port's own copy of
``x_multi_agent_tpu.utils.sim``, numpy only).

Drives the filter through the ``processMatchesMeasurement`` path exactly
like the reference is driven in simulation (``vio.cpp:274``, SURVEY §4.3).
Produces analytically consistent IMU measurements and normalized-coordinate
feature matches with stable track ids (GT landmark association — the
GT_DEBUG-style deterministic harness).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SimData(NamedTuple):
    imu_t: np.ndarray  # (Ni,)
    imu_w: np.ndarray  # (Ni, 3)
    imu_a: np.ndarray  # (Ni, 3)
    cam_t: np.ndarray  # (Nc,)
    cam_p: np.ndarray  # (Nc, 3) true positions
    cam_q: np.ndarray  # (Nc, 4) true attitudes (xyzw)
    # per-frame matches
    match_id: np.ndarray  # (Nc, J)
    match_prev: np.ndarray  # (Nc, J, 2)
    match_cur: np.ndarray  # (Nc, J, 2)
    match_valid: np.ndarray  # (Nc, J)
    landmarks: np.ndarray  # (L, 3)


def make_circle_sim(
    duration: float = 5.0,
    imu_rate: float = 200.0,
    cam_rate: float = 20.0,
    n_landmarks: int = 40,
    match_budget: int = 60,
    radius: float = 1.5,
    omega: float = 1.2,
    pixel_noise: float = 0.0,
    seed: int = 0,
    g: float = -9.81,
    phase: float = 0.0,
    lm_window: "tuple[int, int] | None" = None,
) -> SimData:
    """Level circular trajectory, identity attitude, landmarks on a wall at
    z = 5..9 m in front of the (z-forward) camera.

    ``phase`` offsets the trajectory angle (distinct per-agent paths over
    the SAME world; initial velocity becomes r*omega*[cos(phase),
    sin(phase), 0]). ``lm_window=(lo, hi)`` restricts this agent's visible
    landmarks to ids [lo, hi) — partial scene overlap between agents with
    shifted windows (landmark ids stay GLOBAL so cross-agent GT matching
    remains meaningful). The landmark SET is a function of ``seed`` only.
    """
    rng = np.random.default_rng(seed)

    lm = np.stack(
        [
            rng.uniform(-4, 4, n_landmarks),
            rng.uniform(-4, 4, n_landmarks),
            rng.uniform(5, 9, n_landmarks),
        ],
        axis=1,
    )

    def pos(t):
        a = omega * t + phase
        return np.stack(
            [
                radius * (np.sin(a) - np.sin(phase)),
                radius * (np.cos(phase) - np.cos(a)),
                0 * t,
            ],
            axis=-1,
        )

    def acc(t):
        a = omega * t + phase
        return np.stack(
            [
                -radius * omega**2 * np.sin(a),
                radius * omega**2 * np.cos(a),
                0 * t,
            ],
            axis=-1,
        )

    n_imu = int(duration * imu_rate) + 1
    imu_t = np.arange(n_imu) / imu_rate
    imu_w = np.zeros((n_imu, 3))
    # identity attitude: a_m = a_world - g_vec (specific force)
    imu_a = acc(imu_t) - np.array([0.0, 0.0, g])

    n_cam = int(duration * cam_rate)
    cam_t = (np.arange(n_cam) + 1) / cam_rate
    cam_p = pos(cam_t)
    cam_q = np.tile([0.0, 0.0, 0.0, 1.0], (n_cam, 1))

    def project(p_cam):
        rel = lm - p_cam  # identity attitude, camera = body, z forward
        return rel[:, :2] / rel[:, 2:3]

    j = match_budget
    match_id = np.full((n_cam, j), -1, np.int32)
    match_prev = np.zeros((n_cam, j, 2))
    match_cur = np.zeros((n_cam, j, 2))
    match_valid = np.zeros((n_cam, j), bool)

    lo, hi = (0, n_landmarks) if lm_window is None else lm_window
    lo, hi = max(0, lo), min(n_landmarks, hi)
    vis_ids = np.arange(lo, hi)

    prev_proj = project(pos(np.array([0.0]))[0])
    for f in range(n_cam):
        cur_proj = project(cam_p[f])
        nn = min(len(vis_ids), j)
        noise = pixel_noise * rng.standard_normal((nn, 2)) if pixel_noise else 0.0
        noise_p = pixel_noise * rng.standard_normal((nn, 2)) if pixel_noise else 0.0
        match_id[f, :nn] = vis_ids[:nn]
        match_prev[f, :nn] = prev_proj[vis_ids[:nn]] + noise_p
        match_cur[f, :nn] = cur_proj[vis_ids[:nn]] + noise
        match_valid[f, :nn] = True
        prev_proj = cur_proj

    return SimData(
        imu_t=imu_t,
        imu_w=imu_w,
        imu_a=imu_a,
        cam_t=cam_t,
        cam_p=cam_p,
        cam_q=cam_q,
        match_id=match_id,
        match_prev=match_prev,
        match_cur=match_cur,
        match_valid=match_valid,
        landmarks=lm,
    )
