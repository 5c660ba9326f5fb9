"""Trajectory evaluation: ATE and position NEES (port of
``x_multi_agent_tpu.utils.evaluation``; numpy on host arrays, as there)."""
from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """SE(3) (optionally Sim(3)) alignment of est -> gt (Umeyama). Returns
    (scale, rotation, translation)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    e = est - mu_e
    g = gt - mu_g
    u, d, vt = np.linalg.svd(g.T @ e / len(est))
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    c = np.trace(np.diag(d) @ s) / ((e**2).sum() / len(est)) if with_scale else 1.0
    return c, r, mu_g - c * r @ mu_e


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = False) -> float:
    """Absolute trajectory error RMSE [m]; ``align`` removes the gauge
    (SE(3) alignment) first."""
    if align:
        c, r, t = align_umeyama(est, gt)
        est = (c * (r @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def nees(est_p: np.ndarray, gt_p: np.ndarray, cov_pp: np.ndarray) -> np.ndarray:
    """Per-step normalized estimation error squared of (T, 3) positions
    under (T, 3, 3) covariance blocks; a consistent filter averages ~3."""
    err = est_p - gt_p
    return np.einsum("ti,ti->t", err, np.linalg.solve(cov_pp, err[..., None])[..., 0])
