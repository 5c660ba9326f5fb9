"""Inputs of the filter's three row builders (``msckf.build``,
``msckf_slam.build``, ``slam.build``) made with numpy from a seed: a camera
window along a line looking at landmarks 4-8 m ahead, noisy normalized
observations, and a small covariance. Imports no JAX, so the card's tests
(``test_torch_kernels.py``) use it too.

Agent 0 is plain. With ``edge=True`` agent 1's covariance holds a NaN
outside the pose block (every track of it must be rejected) and agent 2's
is indefinite on the first poses' positions (S does not factorize for the
tracks that see them). Per agent: a fully masked track, a track with one
observation, an outlier track, and tracks that end at the current pose.
"""
from __future__ import annotations

import numpy as np
import torch

from x_multi_agent_torch.ops import lie

SIGMA_IMG = 0.005


def _quat(rng, n, scale):
    q = np.concatenate([rng.normal(size=(n, 3)) * scale, np.ones((n, 1))], axis=1)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rot(q):
    return lie.quat_to_rot(torch.from_numpy(q)).numpy()


def _project(r_wc, p, x):
    cam = np.einsum("...ji,...j->...i", r_wc, x - p)
    return cam[..., :2] / cam[..., 2:3], cam


def _cov(rng, a, m, n, edge):
    d = 15 + 6 * m + 3 * n
    cov = np.empty((a, d, d))
    for i in range(a):
        l = rng.normal(size=(d, d)) * 1e-3 / np.sqrt(d)
        cov[i] = l @ l.T + 1e-6 * np.eye(d)
    if edge and a >= 3:
        cov[1, d - 1, d - 1] = np.nan
        u = np.zeros(d)
        u[15:24] = 1.0
        cov[2] -= 0.5 * np.outer(u, u)
    return cov


def window(seed: int, a: int, k: int, m: int, n: int, edge: bool = False, dtype=torch.float64):
    """(obs, mask, q_arr, p_arr, cov) of ``msckf.build`` / ``msckf_slam.build``."""
    rng = np.random.default_rng(seed)
    q = _quat(rng, a * m, 0.03).reshape(a, m, 4)
    p = np.stack([np.linspace(-1.0, 1.0, m)[None].repeat(a, 0),
                  0.05 * rng.normal(size=(a, m)), 0.02 * rng.normal(size=(a, m))], -1)
    pts = np.stack([rng.uniform(-2, 2, (a, k)), rng.uniform(-1.5, 1.5, (a, k)),
                    rng.uniform(4, 8, (a, k))], -1)
    obs, _ = _project(_rot(q)[:, None], p[:, None], pts[:, :, None])
    obs = obs + rng.normal(size=obs.shape) * SIGMA_IMG
    mask = np.zeros((a, k, m), bool)
    for i in range(a):
        for j in range(k):
            first = rng.integers(0, m - 1)
            mask[i, j, first:] = True
        mask[i, 0] = False  # no observation
        mask[i, 1, :m - 1] = False  # one observation
        obs[i, 2, m - 1] += 0.05  # an outlier
    return tuple(torch.from_numpy(x).to(dtype) if x.dtype != bool else torch.from_numpy(x)
                 for x in (obs, mask, q, p, _cov(rng, a, m, n, edge)))


def slam(seed: int, a: int, m: int, n: int, edge: bool = False, dtype=torch.float64):
    """(f_arr, anchor_idx, q_arr, p_arr, z_obs, active, track_length, cov,
    cur_pose_idx) of ``slam.build``: anchors at every window slot, at the
    current pose (the special rows) and -1 (an empty slot, inactive)."""
    rng = np.random.default_rng(seed)
    q = _quat(rng, a * m, 0.03).reshape(a, m, 4)
    p = np.stack([np.linspace(-1.0, 1.0, m)[None].repeat(a, 0),
                  0.05 * rng.normal(size=(a, m)), 0.02 * rng.normal(size=(a, m))], -1)
    pts = np.stack([rng.uniform(-2, 2, (a, n)), rng.uniform(-1.5, 1.5, (a, n)),
                    rng.uniform(4, 8, (a, n))], -1)
    cur = m - 1
    anchor = rng.integers(0, m, (a, n)).astype(np.int32)
    anchor[:, 0] = cur
    anchor[:, 1] = -1
    r = _rot(q)
    ia = np.arange(a)[:, None]
    _, cam = _project(r[ia, anchor], p[ia, anchor], pts)
    f_arr = np.stack([cam[..., 0] / cam[..., 2], cam[..., 1] / cam[..., 2], 1 / cam[..., 2]], -1)
    z, _ = _project(r[:, cur][:, None], p[:, cur][:, None], pts)
    z = z + rng.normal(size=z.shape) * SIGMA_IMG
    z[:, 2] += 0.05  # an outlier
    active = rng.random((a, n)) < 0.85
    active[:, 1] = False
    length = rng.integers(1, 20, (a, n)).astype(np.int32)
    length[:, 3] = 0
    cov = _cov(rng, a, m, n, edge)
    f = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    return (f(f_arr), torch.from_numpy(anchor), f(q), f(p), f(z), torch.from_numpy(active),
            torch.from_numpy(length), f(cov), cur)
