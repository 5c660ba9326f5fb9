"""Synthetic textured-wall scene (port of ``x_multi_agent_tpu.utils.scene``):
the multi-octave texture, the circle and 6-DoF orbit trajectories with their
IMU streams, the numpy single-frame renderer, a batched torch renderer (with
an optional second wall), the baked thermal degradation, and the EuRoC-style
dataset writers (``imu.csv``, ``cam/data.csv`` + ``%06d.pgm``, ``gt.csv``)
that ``utils/dataio.py`` reads.

Random draws are numpy's, in the reference's order, so a seed gives the
reference's texture, trajectory and thermal noise; the texture's blotch pass
and the batched renderer run in torch on the device they are given.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve
from ..vision.image import bilinear_sample


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


def render_wall_float(
    tex: torch.Tensor,  # (th, tw)
    p,  # (B, 3) camera positions (world)
    rot,  # (B, 3, 3) world <- camera
    h: int,
    w: int,
    fx: float,
    fy: float,
    wall_z: float = 6.0,
    m_per_px: float = 0.004,
    wall2_x: float = None,
    dtype=torch.float64,
) -> torch.Tensor:
    """(B, h, w) views of the textured wall plane z = wall_z in ``dtype``
    (not clipped or rounded): each pixel's ray meets the wall; intensity is
    a bilinear texture lookup (edge-clamped) at the hit point. ``wall2_x``
    adds a side wall, the plane x = wall2_x, seen where a ray meets it
    (more than 0.1 along the ray) before the front wall or misses the front
    wall; its texture is read at an offset of (+511, +257) texels."""
    dev = tex.device
    p = torch.as_tensor(p, dtype=dtype, device=dev)
    rot = torch.as_tensor(rot, dtype=dtype, device=dev)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    v = torch.arange(h, dtype=dtype, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=dtype, device=dev)[None, :].expand(h, w)
    d_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    d_w = torch.einsum("hwj,bij->bhwi", d_cam, rot)
    px, py, pz = (p[:, i, None, None] for i in range(3))
    t1 = (wall_z - pz) / d_w[..., 2]
    th, tw = tex.shape
    tf = tex.to(dtype)
    img = bilinear_sample(tf, torch.stack([(px + t1 * d_w[..., 0]) / m_per_px + tw / 2.0,
                                           (py + t1 * d_w[..., 1]) / m_per_px + th / 2.0], -1))
    if wall2_x is not None:
        dx = d_w[..., 0]
        t2 = (wall2_x - px) / torch.where(torch.abs(dx) > 1e-6, dx, 1e-6)
        hit2 = (t2 > 0.1) & ((t2 < t1) | (t1 <= 0.0))
        img2 = bilinear_sample(tf, torch.stack([(py + t2 * d_w[..., 1]) / m_per_px + tw / 2.0 + 511.0,
                                                (pz + t2 * d_w[..., 2]) / m_per_px + th / 2.0 + 257.0],
                                               -1))
        img = torch.where(hit2, img2, img)
    return img


def render_wall_frames(
    tex: torch.Tensor,  # (th, tw) uint8
    p,  # (B, 3) camera positions (world)
    rot,  # (B, 3, 3) world <- camera
    h: int,
    w: int,
    fx: float,
    fy: float,
    wall_z: float = 6.0,
    m_per_px: float = 0.004,
    wall2_x: float = None,
) -> torch.Tensor:
    """(B, h, w) uint8 views of :func:`render_wall_float` (float64),
    clipped and truncated as the numpy renderer writes them."""
    img = render_wall_float(tex, p, rot, h, w, fx, fy, wall_z, m_per_px, wall2_x)
    return torch.clamp(img, 0, 255).to(torch.uint8)


def thermal_vignette(h: int, w: int, peak: float, device=None) -> torch.Tensor:
    """(h, w) float32 additive vignette, ``peak`` at the corners
    (normalized units): peak * r^2 / 2 with r the distance from the centre
    in half-extents."""
    device = resolve(device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    r2 = ((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2
    return peak * r2 / 2.0


def thermal_degrade(img: torch.Tensor, a, b, vignette: torch.Tensor, noise: torch.Tensor):
    """The baked thermal degradation of one or more frames: the affine gain
    (a, b) on the [0, 1] intensity, the additive vignette and noise, clipped
    to [0, 1], back in [0, 255] as float64. The intensity is scaled in
    float32 and the rest runs in float64, as the reference's numpy writer
    computes it; ``noise`` is the additive noise itself (std applied)."""
    x = (img.to(torch.float32) / 255.0).to(torch.float64)
    x = x * (a - b) + b + vignette.to(torch.float64) + noise
    return torch.clamp(x, 0, 1) * 255.0


def degrade_frames(frames: torch.Tensor, gains, vignette: float, noise: float,
                   generator: torch.Generator) -> torch.Tensor:
    """A sequence of frames (n, h, w) in [0, 255] degraded on their device
    as the dataset generator bakes it (:func:`thermal_degrade`): frame k
    under the gains ``gains[k]`` = (a, b), a ``vignette`` peak, Gaussian
    noise of std ``noise`` drawn from ``generator`` (float64, one (h, w)
    draw per frame in order); clipped and cast to uint8 as the generator
    writes its PGMs."""
    n, h, w = frames.shape
    vig = thermal_vignette(h, w, vignette, frames.device)
    out = torch.empty((n, h, w), dtype=torch.uint8, device=frames.device)
    for k, (a, b) in enumerate(gains):
        z = torch.randn((h, w), generator=generator, dtype=torch.float64, device=frames.device)
        out[k] = torch.clamp(thermal_degrade(frames[k], a, b, vig, noise * z), 0, 255).to(torch.uint8)
    return out


# --------------------------------------------------------------------------
# numpy single-frame renderer and the circle-trajectory dataset
# --------------------------------------------------------------------------


def _bilinear(tex: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = tex.shape
    x = np.clip(x, 0.0, w - 1.001)
    y = np.clip(y, 0.0, h - 1.001)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = x - x0
    fy = y - y0
    t = tex.astype(np.float64)
    return (
        t[y0, x0] * (1 - fx) * (1 - fy)
        + t[y0, x0 + 1] * fx * (1 - fy)
        + t[y0 + 1, x0] * (1 - fx) * fy
        + t[y0 + 1, x0 + 1] * fx * fy
    )


def render_wall_frame(tex: np.ndarray, p: np.ndarray, rot: np.ndarray, h: int, w: int,
                      fx: float, fy: float, wall_z: float = 6.0,
                      m_per_px: float = 0.004) -> np.ndarray:
    """(h, w) uint8 numpy view of the textured wall plane z = wall_z from a
    camera at ``p`` with attitude ``rot`` (world <- camera)."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    d_w = d_cam @ rot.T
    t = (wall_z - p[2]) / d_w[..., 2]
    wx = p[0] + t * d_w[..., 0]
    wy = p[1] + t * d_w[..., 1]
    th, tw = tex.shape
    img = _bilinear(tex, wx / m_per_px + tw / 2.0, wy / m_per_px + th / 2.0)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_pgm(path: str, img: np.ndarray) -> None:
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """xyzw quaternion -> rotation matrix (world <- camera)."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _write_imu(out_dir, imu_t, imu_w, imu_a):
    with open(os.path.join(out_dir, "imu.csv"), "w") as f:
        f.write("# t, wx, wy, wz, ax, ay, az\n")
        for i in range(len(imu_t)):
            f.write(
                f"{imu_t[i]:.6f},{imu_w[i,0]:.9f},{imu_w[i,1]:.9f},"
                f"{imu_w[i,2]:.9f},{imu_a[i,0]:.9f},{imu_a[i,1]:.9f},"
                f"{imu_a[i,2]:.9f}\n"
            )


def _write_gt(out_dir, cam_t, cam_p, cam_q):
    with open(os.path.join(out_dir, "gt.csv"), "w") as f:
        f.write("# t, px, py, pz, qx, qy, qz, qw\n")
        for i in range(len(cam_t)):
            f.write(f"{cam_t[i]:.6f}," + ",".join(f"{v:.9f}" for v in cam_p[i]) + ","
                    + ",".join(f"{v:.9f}" for v in cam_q[i]) + "\n")


def generate_agent_dataset(
    out_dir: str,
    seed: int,
    duration: float = 30.0,
    imu_rate: float = 100.0,
    cam_rate: float = 10.0,
    h: int = 480,
    w: int = 640,
    fx_frac: float = 0.8,
    radius: float = 1.5,
    omega: float = 0.6,
    imu_noise_w: float = 2e-4,
    imu_noise_a: float = 2e-3,
    wall_z: float = 6.0,
    tex: np.ndarray = None,
    phase: float = 0.0,
) -> dict:
    """One agent's EuRoC-style dataset on the circle trajectory (z = 0
    plane, identity attitude, z-forward camera facing the wall, phase
    offset ``phase``), rendered with the numpy renderer: ``imu.csv``,
    ``cam/data.csv`` + ``cam/%06d.pgm`` and ``gt.csv`` (t, p, q xyzw).
    Returns the ground-truth arrays."""
    rng = np.random.default_rng(seed)
    if tex is None:
        tex = make_texture(0, device="cpu").numpy()
    tex = np.asarray(tex)
    os.makedirs(os.path.join(out_dir, "cam"), exist_ok=True)

    def pos(t):
        a = omega * t + phase
        return np.stack([radius * (np.sin(a) - np.sin(phase)),
                         radius * (np.cos(phase) - np.cos(a)), 0 * t], axis=-1)

    def acc(t):
        a = omega * t + phase
        return np.stack([-radius * omega**2 * np.sin(a), radius * omega**2 * np.cos(a), 0 * t],
                        axis=-1)

    def vel(t):
        a = omega * t + phase
        return np.stack([radius * omega * np.cos(a), radius * omega * np.sin(a), 0 * t], axis=-1)

    n_imu = int(duration * imu_rate) + 1
    imu_t = np.arange(n_imu) / imu_rate
    imu_w = imu_noise_w * rng.standard_normal((n_imu, 3))
    imu_a = acc(imu_t) - np.array([0.0, 0.0, -9.81]) + imu_noise_a * rng.standard_normal((n_imu, 3))
    _write_imu(out_dir, imu_t, imu_w, imu_a)

    n_cam = int(duration * cam_rate)
    cam_t = (np.arange(n_cam) + 1) / cam_rate
    cam_p = pos(cam_t)
    cam_q = np.tile([0.0, 0.0, 0.0, 1.0], (n_cam, 1))
    fx = fx_frac * w
    with open(os.path.join(out_dir, "cam", "data.csv"), "w") as f:
        f.write("# t, filename\n")
        for i in range(n_cam):
            name = f"{i:06d}.pgm"
            write_pgm(os.path.join(out_dir, "cam", name),
                      render_wall_frame(tex, cam_p[i], np.eye(3), h, w, fx, fx, wall_z=wall_z))
            f.write(f"{cam_t[i]:.6f},{name}\n")
    _write_gt(out_dir, cam_t, cam_p, cam_q)
    return dict(imu_t=imu_t, imu_w=imu_w, imu_a=imu_a, cam_t=cam_t, cam_p=cam_p, cam_q=cam_q,
                v0=vel(np.array([0.0]))[0], fx=fx, fy=fx, h=h, w=w)


# --------------------------------------------------------------------------
# 6-DoF orbit trajectory (rotation included)
# --------------------------------------------------------------------------


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
                  m_per_px: float = 0.004, agents: slice = slice(None)):
    """The image benchmark's data: per-agent 6-DoF orbits (radius 1.5 m,
    0.6 rad/s, phases spread over the circle, 20 Hz camera, 200 Hz IMU, 10
    IMU samples per frame) over the textured wall, fx = fy = 0.8 w.

    Returns frames (n_frames, A, h, w) float32 on ``device`` and the IMU
    windows (times, seqs, w_m, a_m), each (n_frames, A, 10, ...), float32 /
    int32 on ``device``, for the ``agents`` of the ``n_agents`` orbits (a
    rank's block renders only its own)."""
    tex = make_texture(0, size=tex_size, device=device)
    trajs = _orbits(n_agents, n_frames)[agents]
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


def generate_agent_dataset_6dof(
    out_dir: str,
    seed: int,
    duration: float = 60.0,
    imu_rate: float = 100.0,
    cam_rate: float = 10.0,
    h: int = 480,
    w: int = 640,
    fx_frac: float = 0.8,
    radius: float = 1.5,
    omega: float = 0.6,
    imu_noise_w: float = 2e-4,
    imu_noise_a: float = 2e-3,
    wall_z: float = 6.0,
    wall2_x: float = None,
    tex=None,
    phase: float = 0.0,
    yaw_amp: float = 0.12,
    pitch_amp: float = 0.08,
    roll_amp: float = 0.06,
    z_amp: float = 0.25,
    thermal: dict = None,
    chunk: int = 32,
    device=None,
) -> dict:
    """One agent's EuRoC-style dataset on the 6-DoF orbit (:func:`orbit_traj`),
    with an optional side wall (a non-planar scene) and an optional baked
    thermal degradation ``thermal=dict(drift_a, drift_b, noise, vignette)``
    (per-second gain drifts, a Gaussian noise std and a corner vignette, in
    normalized units; optional sinusoids ``gain_amp`` and ``bias_amp`` of
    period ``gain_period``) that the online photometric calibration must
    undo.

    Frames are rendered on ``device`` in chunks of ``chunk``, in float32 as
    the reference renders them; the degradation runs on the host with the
    reference's numpy draws (one (h, w) normal draw per frame, in frame
    order), so a seed gives the reference's noise. Writes the files of
    :func:`generate_agent_dataset`; returns the ground-truth arrays."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    tex = make_texture(0, device=device) if tex is None else torch.as_tensor(tex, device=device)
    os.makedirs(os.path.join(out_dir, "cam"), exist_ok=True)
    traj = orbit_traj(
        duration, imu_rate, cam_rate, radius=radius, omega=omega, phase=phase,
        yaw_amp=yaw_amp, pitch_amp=pitch_amp, roll_amp=roll_amp, z_amp=z_amp, seed=seed,
        imu_noise_w=imu_noise_w, imu_noise_a=imu_noise_a,
    )
    cam_t, cam_p, cam_q, cam_rot = traj["cam_t"], traj["cam_p"], traj["cam_q"], traj["cam_rot"]
    _write_imu(out_dir, traj["imu_t"], traj["imu_w"], traj["imu_a"])
    fx = fx_frac * w
    n_cam = len(cam_t)
    if thermal is not None:
        vignette = thermal_vignette(h, w, thermal.get("vignette", 0.0), "cpu")
    with open(os.path.join(out_dir, "cam", "data.csv"), "w") as f:
        f.write("# t, filename\n")
        for c0 in range(0, n_cam, chunk):
            c1 = min(c0 + chunk, n_cam)
            imgs = render_wall_float(tex, cam_p[c0:c1], cam_rot[c0:c1], h, w, fx, fx,
                                     wall_z=wall_z, wall2_x=wall2_x, dtype=torch.float32).cpu()
            for i in range(c0, c1):
                img = imgs[i - c0]
                if thermal is not None:
                    t, per = float(cam_t[i]), thermal.get("gain_period", 13.0)
                    a = (1.0 + thermal.get("drift_a", 0.0) * t
                         + thermal.get("gain_amp", 0.0) * np.sin(2 * np.pi * t / per))
                    b = (thermal.get("drift_b", 0.0) * t
                         + thermal.get("bias_amp", 0.0) * np.sin(2 * np.pi * t / (per * 1.7) + 0.8))
                    noise = thermal.get("noise", 0.0) * rng.standard_normal((h, w))
                    img = thermal_degrade(img, a, b, vignette, torch.from_numpy(noise))
                name = f"{i:06d}.pgm"
                write_pgm(os.path.join(out_dir, "cam", name),
                          torch.clamp(img, 0, 255).to(torch.uint8).numpy())
                f.write(f"{cam_t[i]:.6f},{name}\n")
    _write_gt(out_dir, cam_t, cam_p, cam_q)
    return dict(
        imu_t=traj["imu_t"], imu_w=traj["imu_w"], imu_a=traj["imu_a"],
        cam_t=cam_t, cam_p=cam_p, cam_q=cam_q, p0=traj["p0"], v0=traj["v0"], q0=traj["q0"],
        fx=fx, fy=fx, h=h, w=w,
    )
