"""Synthetic textured-wall scene for smoke runs and benchmarks (port of the
numpy parts of ``x_multi_agent_tpu.utils.scene`` that the image benchmark
uses): the multi-octave texture, the 6-DoF orbit trajectory with its IMU
stream, and a batched renderer.

Random draws are numpy's, in the reference's order, so a seed gives the
reference's texture and trajectory; the texture's blotch pass and the
renderer run in torch (float64) on the device they are given.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve


def make_texture(seed: int = 0, size: int = 2048, octaves: int = 5, device=None) -> torch.Tensor:
    """Multi-octave value-noise texture with speckle and sparse blotches,
    uint8 (size, size) on ``device``."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float64)
    amp = 1.0
    for o in range(octaves):
        n = 8 << o
        coarse = rng.normal(size=(n, n))
        yi = np.linspace(0, n - 1, size)
        y0 = np.floor(yi).astype(int)
        y1 = np.minimum(y0 + 1, n - 1)
        f = (yi - y0)
        fy, fx = f[:, None], f[None, :]
        up = (
            coarse[np.ix_(y0, y0)] * (1 - fy) * (1 - fx)
            + coarse[np.ix_(y0, y1)] * (1 - fy) * fx
            + coarse[np.ix_(y1, y0)] * fy * (1 - fx)
            + coarse[np.ix_(y1, y1)] * fy * fx
        )
        tex += amp * up
        amp *= 0.55
    tex += 0.35 * rng.normal(size=(size, size))
    out = torch.as_tensor(tex, dtype=torch.float64, device=device)
    ar = torch.arange(size, dtype=torch.float32, device=device).to(torch.float64)
    yy, xx = ar[:, None], ar[None, :]
    for _ in range(160):
        cx, cy = rng.uniform(0, size, 2)
        rx, ry = rng.uniform(6, 60, 2)
        th = rng.uniform(0, np.pi)
        amp = rng.uniform(1.5, 4.0) * rng.choice([-1.0, 1.0])
        dx, dy = xx - cx, yy - cy
        u = (dx * np.cos(th) + dy * np.sin(th)) / rx
        v = (-dx * np.sin(th) + dy * np.cos(th)) / ry
        out += amp * ((u * u + v * v) < 1.0)
    out -= out.min()
    out *= 255.0 / out.max()
    return out.to(torch.uint8)


def render_wall_frames(
    tex: torch.Tensor,  # (th, tw) uint8
    p: torch.Tensor,  # (B, 3) camera positions (world)
    rot: torch.Tensor,  # (B, 3, 3) world <- camera
    h: int,
    w: int,
    fx: float,
    fy: float,
    wall_z: float = 6.0,
    m_per_px: float = 0.004,
) -> torch.Tensor:
    """(B, h, w) uint8 views of the textured wall plane z = wall_z: each
    pixel's ray meets the wall; intensity is a bilinear texture lookup
    (edge-clamped) at the hit point."""
    dev = tex.device
    p = torch.as_tensor(p, dtype=torch.float64, device=dev)
    rot = torch.as_tensor(rot, dtype=torch.float64, device=dev)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    v = torch.arange(h, dtype=torch.float64, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float64, device=dev)[None, :].expand(h, w)
    d_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    d_w = torch.einsum("hwj,bij->bhwi", d_cam, rot)
    t = (wall_z - p[:, 2, None, None]) / d_w[..., 2]
    wx = p[:, 0, None, None] + t * d_w[..., 0]
    wy = p[:, 1, None, None] + t * d_w[..., 1]
    th, tw = tex.shape
    x = torch.clamp(wx / m_per_px + tw / 2.0, 0.0, tw - 1.001)
    y = torch.clamp(wy / m_per_px + th / 2.0, 0.0, th - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    fx_, fy_ = x - x0, y - y0
    tf = tex.to(torch.float64)
    img = (
        tf[y0, x0] * (1 - fx_) * (1 - fy_)
        + tf[y0, x0 + 1] * fx_ * (1 - fy_)
        + tf[y0 + 1, x0] * (1 - fx_) * fy_
        + tf[y0 + 1, x0 + 1] * fx_ * fy_
    )
    return torch.clamp(img, 0, 255).to(torch.uint8)


def _rot_xyz(pitch: np.ndarray, yaw: np.ndarray, roll: np.ndarray) -> np.ndarray:
    """R = Ry(yaw) @ Rx(pitch) @ Rz(roll), batched; world <- camera, camera
    z-forward toward the wall."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    z = np.zeros_like(yaw)
    o = np.ones_like(yaw)
    ry = np.stack([cy, z, sy, z, o, z, -sy, z, cy], axis=-1).reshape(yaw.shape + (3, 3))
    rx = np.stack([o, z, z, z, cp, -sp, z, sp, cp], axis=-1).reshape(yaw.shape + (3, 3))
    rz = np.stack([cr, -sr, z, sr, cr, z, z, z, o], axis=-1).reshape(yaw.shape + (3, 3))
    return ry @ rx @ rz


def rot_to_quat(rot: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> xyzw quaternion (w >= 0)."""
    m = rot
    w = 0.5 * np.sqrt(np.maximum(1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2], 1e-12))
    x = (m[..., 2, 1] - m[..., 1, 2]) / (4 * w)
    y = (m[..., 0, 2] - m[..., 2, 0]) / (4 * w)
    z = (m[..., 1, 0] - m[..., 0, 1]) / (4 * w)
    return np.stack([x, y, z, w], axis=-1)


def orbit_traj(
    duration: float,
    imu_rate: float,
    cam_rate: float,
    radius: float = 1.5,
    omega: float = 0.6,
    phase: float = 0.0,
    yaw_amp: float = 0.0,
    pitch_amp: float = 0.0,
    roll_amp: float = 0.0,
    rot_freq: float = 1.3,
    z_amp: float = 0.0,
    seed: int = 0,
    imu_noise_w: float = 2e-4,
    imu_noise_a: float = 2e-3,
) -> dict:
    """6-DoF orbit: a circle with sinusoidal yaw/pitch/roll and z bobbing.
    Body rates come from the analytic R(t) by central differences at the IMU
    rate; accel is analytic, rotated into the body frame. Returns imu_t,
    imu_w, imu_a, cam_t, cam_p, cam_rot (n,3,3), cam_q (xyzw), p0, v0, q0."""
    rng = np.random.default_rng(seed)
    g = np.array([0.0, 0.0, -9.81])

    def pos(t):
        a = omega * t + phase
        return np.stack([radius * (np.sin(a) - np.sin(phase)),
                         radius * (np.cos(phase) - np.cos(a)),
                         z_amp * np.sin(0.9 * omega * t)], axis=-1)

    def vel(t):
        a = omega * t + phase
        return np.stack([radius * omega * np.cos(a), radius * omega * np.sin(a),
                         z_amp * 0.9 * omega * np.cos(0.9 * omega * t)], axis=-1)

    def acc(t):
        a = omega * t + phase
        return np.stack([-radius * omega**2 * np.sin(a), radius * omega**2 * np.cos(a),
                         -z_amp * (0.9 * omega) ** 2 * np.sin(0.9 * omega * t)], axis=-1)

    def rot(t):
        wt = rot_freq * omega * t + phase
        return _rot_xyz(pitch_amp * np.sin(0.83 * wt), yaw_amp * np.sin(wt),
                        roll_amp * np.sin(1.19 * wt + 0.5))

    n_imu = int(duration * imu_rate) + 1
    imu_t = np.arange(n_imu) / imu_rate
    h_fd = 0.5 / imu_rate
    dr = np.einsum("nij,nik->njk", rot(imu_t - h_fd), rot(imu_t + h_fd))
    tr = np.clip((np.trace(dr, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.arccos(tr)
    s = np.where(ang > 1e-12, ang / np.maximum(np.sin(ang), 1e-12), 1.0)
    w_body = (
        np.stack([dr[:, 2, 1] - dr[:, 1, 2], dr[:, 0, 2] - dr[:, 2, 0],
                  dr[:, 1, 0] - dr[:, 0, 1]], axis=-1)
        * (s / 2.0)[:, None] / (2.0 * h_fd)
    )
    a_body = np.einsum("nij,ni->nj", rot(imu_t), acc(imu_t) - g)  # R^T (a - g)
    imu_w = w_body + imu_noise_w * rng.standard_normal((n_imu, 3))
    imu_a = a_body + imu_noise_a * rng.standard_normal((n_imu, 3))
    n_cam = int(duration * cam_rate)
    cam_t = (np.arange(n_cam) + 1) / cam_rate
    cam_rot = rot(cam_t)
    return dict(
        imu_t=imu_t, imu_w=imu_w, imu_a=imu_a, cam_t=cam_t, cam_p=pos(cam_t),
        cam_rot=cam_rot, cam_q=rot_to_quat(cam_rot), p0=pos(np.array([0.0]))[0],
        v0=vel(np.array([0.0]))[0], q0=rot_to_quat(rot(np.array([0.0])))[0],
    )


def _orbits(n_agents: int, n_frames: int):
    """The image benchmark's per-agent orbits (20 Hz camera, 200 Hz IMU)."""
    return [
        orbit_traj(duration=(n_frames + 1) / 20.0, imu_rate=200.0, cam_rate=20.0,
                   radius=1.5, omega=0.6, phase=2.0 * np.pi * i / max(n_agents, 1),
                   yaw_amp=0.15, pitch_amp=0.10, roll_amp=0.08, z_amp=0.3, seed=i)
        for i in range(n_agents)
    ]


def orbit_start(n_agents: int):
    """Each agent's true initial state on :func:`orbit_dataset`'s orbits:
    (p0 (A, 3), v0 (A, 3), q0 (A, 4)) numpy, for ``init_at_time``."""
    trajs = _orbits(n_agents, 1)
    return tuple(np.stack([t_[k] for t_ in trajs]) for k in ("p0", "v0", "q0"))


def orbit_dataset(n_agents: int, n_frames: int, h: int, w: int, device, tex_size: int = 2048,
                  m_per_px: float = 0.004):
    """The image benchmark's data: per-agent 6-DoF orbits (radius 1.5 m,
    0.6 rad/s, phases spread over the circle, 20 Hz camera, 200 Hz IMU, 10
    IMU samples per frame) over the textured wall, fx = fy = 0.8 w.

    Returns frames (n_frames, A, h, w) float32 on ``device`` and the IMU
    windows (times, seqs, w_m, a_m), each (n_frames, A, 10, ...), float32 /
    int32 on ``device``."""
    tex = make_texture(0, size=tex_size, device=device)
    trajs = _orbits(n_agents, n_frames)
    p_all = np.stack([t_["cam_p"][:n_frames] for t_ in trajs], axis=1)
    r_all = np.stack([t_["cam_rot"][:n_frames] for t_ in trajs], axis=1)
    fx = 0.8 * w
    frames = torch.stack([
        render_wall_frames(tex, p_all[k], r_all[k], h, w, fx, fx, m_per_px=m_per_px)
        for k in range(n_frames)
    ]).to(torch.float32)
    idx = np.arange(n_frames)[:, None] * 10 + np.arange(1, 11)[None, :]  # (n_frames, 10)

    def per_frame(key):
        return np.stack([t_[key][idx] for t_ in trajs], axis=1)  # (n_frames, A, 10, ...)

    f32 = dict(dtype=torch.float32, device=device)
    times = torch.as_tensor(per_frame("imu_t"), **f32)
    seqs = torch.as_tensor(np.broadcast_to(idx[:, None], times.shape).copy(),
                           dtype=torch.int32, device=device)
    return frames, (times, seqs, torch.as_tensor(per_frame("imu_w"), **f32),
                    torch.as_tensor(per_frame("imu_a"), **f32))
