"""The benchmark's input generator: periodic rings of fleet inputs, made on
the device from the run's seed.

Two kinds of input, chosen by a traffic file's ``input``:

* ``image``: every agent flies a 6-DoF orbit in front of a textured wall
  (the JAX package's ``scene.orbit_traj`` / ``orbit_dataset``: radius 1.5 m,
  yaw 0.15, pitch 0.10 and roll 0.08 rad, 0.3 m of z bobbing, phases spread
  over the circle), rendered at the configuration's resolution. Every
  frequency is a whole multiple of 2 pi / T, T = ring frames / camera rate,
  so the ring closes: frame ``k`` of a run is ring frame ``k % L`` with its
  times advanced by ``(k // L) * T`` and its IMU sequence numbers by
  ``(k // L) * L * imu_per_frame``.
* ``matches``: the circle simulation of the JAX package's
  ``sim.make_circle_sim`` / ``bench.match_inputs_stacked``: wall landmarks
  seen along a level circle with identity attitude, matches with stable
  track ids, ~3 % of them dropped per agent and frame, jitter on the points
  and the IMU. Its angular rate is 2 pi / T, so it closes the same way.

The seed draws the fleet's phase offset, the IMU noise, the landmarks, the
churn and the jitter; the wall's texture comes from the traffic file's
``texture_seed``, so every seed flies over the same wall (the same work
in another order). Every draw is a ``torch.Generator`` on the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

GRAVITY = (0.0, 0.0, -9.81)


def generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def texture(seed: int, size: int, device: torch.device) -> torch.Tensor:
    """Multi-octave value noise with speckle and 160 elliptic blotches,
    uint8 (size, size): the JAX package's ``scene.make_texture`` recipe,
    drawn on the device."""
    g = generator(device, seed)
    f64 = dict(dtype=torch.float64, device=device)
    tex = torch.zeros((size, size), **f64)
    amp = 1.0
    for octave in range(5):
        n = 8 << octave
        coarse = torch.randn((1, 1, n, n), generator=g, **f64)
        tex += amp * F.interpolate(coarse, size=(size, size), mode="bilinear",
                                   align_corners=True)[0, 0]
        amp *= 0.55
    tex += 0.35 * torch.randn((size, size), generator=g, **f64)
    n_blot = 160
    u = torch.rand((n_blot, 6), generator=g, **f64)
    cx, cy = u[:, 0] * size, u[:, 1] * size
    rx, ry = 6 + 54 * u[:, 2], 6 + 54 * u[:, 3]
    th = math.pi * u[:, 4]
    sign = torch.where(torch.rand((n_blot,), generator=g, **f64) < 0.5, -1.0, 1.0)
    bamp = (1.5 + 2.5 * u[:, 5]) * sign
    ar = torch.arange(size, **f64)
    for b in range(0, n_blot, 16):  # 16 blotches per pass over the wall
        sl = slice(b, b + 16)
        dx = ar[None, None, :] - cx[sl, None, None]
        dy = ar[None, :, None] - cy[sl, None, None]
        c, s = torch.cos(th[sl])[:, None, None], torch.sin(th[sl])[:, None, None]
        uu = (dx * c + dy * s) / rx[sl, None, None]
        vv = (-dx * s + dy * c) / ry[sl, None, None]
        tex += (bamp[sl, None, None] * ((uu * uu + vv * vv) < 1.0)).sum(0)
    tex -= tex.min()
    tex *= 255.0 / tex.max()
    return tex.to(torch.uint8)


def render(tex: torch.Tensor, p: torch.Tensor, rot: torch.Tensor, h: int, w: int, fx: float,
           wall_z: float = 6.0, m_per_px: float = 0.004) -> torch.Tensor:
    """(B, h, w) float32 views of the wall z = ``wall_z`` from cameras at
    ``p`` (B, 3) with attitude ``rot`` (B, 3, 3) world <- camera, fx = fy:
    a bilinear, edge-clamped texture lookup where each pixel's ray meets
    the wall, clipped to [0, 255] and truncated to whole gray levels as a
    camera's 8-bit frame (``scene.render_wall_frames``)."""
    dt, dev = torch.float64, tex.device
    v = torch.arange(h, dtype=dt, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=dt, device=dev)[None, :].expand(h, w)
    d_cam = torch.stack([(u - (w - 1) / 2.0) / fx, (v - (h - 1) / 2.0) / fx,
                         torch.ones_like(u)], dim=-1)
    d_w = torch.einsum("hwj,bij->bhwi", d_cam, rot.to(dt))
    px, py, pz = (p[:, i, None, None].to(dt) for i in range(3))
    t = (wall_z - pz) / d_w[..., 2]
    th, tw = tex.shape
    x = torch.clamp((px + t * d_w[..., 0]) / m_per_px + tw / 2.0, 0.0, tw - 1.001)
    y = torch.clamp((py + t * d_w[..., 1]) / m_per_px + th / 2.0, 0.0, th - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = torch.clamp(x0 + 1, max=tw - 1), torch.clamp(y0 + 1, max=th - 1)
    fxx, fyy = x - x0, y - y0
    flat = tex.to(dt).reshape(-1)

    def at(yy, xx):
        return flat[yy * tw + xx]

    img = (at(y0, x0) * (1 - fxx) * (1 - fyy) + at(y0, x1) * fxx * (1 - fyy)
           + at(y1, x0) * (1 - fxx) * fyy + at(y1, x1) * fxx * fyy)
    return torch.clamp(img, 0, 255).to(torch.uint8).to(torch.float32)


def _rot_xyz(pitch, yaw, roll) -> torch.Tensor:
    """R = Ry(yaw) @ Rx(pitch) @ Rz(roll), batched; world <- camera."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(yaw.shape + (3, 3))
    rx = torch.stack([o, z, z, z, cp, -sp, z, sp, cp], -1).reshape(yaw.shape + (3, 3))
    rz = torch.stack([cr, -sr, z, sr, cr, z, z, z, o], -1).reshape(yaw.shape + (3, 3))
    return ry @ rx @ rz


def rot_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> xyzw quaternion (w >= 0)."""
    w = 0.5 * torch.sqrt(torch.clamp(1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2], min=1e-12))
    return torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / (4 * w),
                        (m[..., 0, 2] - m[..., 2, 0]) / (4 * w),
                        (m[..., 1, 0] - m[..., 0, 1]) / (4 * w), w], -1)


class Ring(NamedTuple):
    """One period of fleet inputs, (L, A, ...) per leaf: the frames (image
    input only, else None), the IMU windows and, for the match input, the
    matches; ``start`` is each agent's true state at t = 0 (p, v, q)."""

    period_s: float
    imu_per_frame: int
    frames: object  # (L, A, H, W) float32 or None
    times: torch.Tensor  # (L, A, n) float32, one period's times
    seqs: torch.Tensor  # (L, A, n) int32
    w_m: torch.Tensor  # (L, A, n, 3)
    a_m: torch.Tensor  # (L, A, n, 3)
    matches: object  # dict of (L, A, J, ...) tensors or None
    start: tuple  # (p0, v0, q0), each (A, k) float64

    @property
    def length(self) -> int:
        return self.times.shape[0]

    def frame(self, k: int) -> dict:
        """Run frame ``k``'s inputs: views of ring frame ``k % L`` with its
        times and sequence numbers advanced by whole periods (a scalar
        added on the device: no copy from the host)."""
        j, lap = k % self.length, k // self.length
        out = {"times": self.times[j] + lap * self.period_s,
               "seqs": self.seqs[j] + lap * self.length * self.imu_per_frame,
               "w_m": self.w_m[j], "a_m": self.a_m[j]}
        out["meas_time"] = out["times"][:, -1]
        if self.frames is not None:
            out["image"] = self.frames[j]
        if self.matches is not None:
            out.update({name: x[j] for name, x in self.matches.items()})
        return out


def orbit(o: dict, om: float, phase: torch.Tensor):
    """(pos, vel, acc, rot) of each agent's orbit, functions of time (1, n)
    -> (A, n, ...): a circle of ``o["radius"]`` at angular rate ``om`` from
    each agent's ``phase`` (A, 1), z bobbing, and yaw, pitch and roll
    swinging at whole multiples (``o["harmonics"]``) of ``om``."""
    r, z_amp = o["radius"], o["z_amp"]
    hz, hy, hp, hr = (o["harmonics"][k] for k in ("z", "yaw", "pitch", "roll"))

    def pos(t):
        a = om * t + phase
        return torch.stack([r * (torch.sin(a) - torch.sin(phase)),
                            r * (torch.cos(phase) - torch.cos(a)),
                            z_amp * torch.sin(hz * om * t).expand_as(a)], -1)

    def vel(t):
        a = om * t + phase
        return torch.stack([r * om * torch.cos(a), r * om * torch.sin(a),
                            (z_amp * hz * om * torch.cos(hz * om * t)).expand_as(a)], -1)

    def acc(t):
        a = om * t + phase
        return torch.stack([-r * om ** 2 * torch.sin(a), r * om ** 2 * torch.cos(a),
                            (-z_amp * (hz * om) ** 2 * torch.sin(hz * om * t)).expand_as(a)], -1)

    def rot(t):
        wt = om * t + phase
        return _rot_xyz(o["pitch_amp"] * torch.sin(hp * wt), o["yaw_amp"] * torch.sin(hy * wt),
                        o["roll_amp"] * torch.sin(hr * wt + 0.5))

    return pos, vel, acc, rot


def orbit_ring(mix: dict, agents: int, h: int, w: int, seed: int, device) -> Ring:
    """The ``image`` input: each agent's orbit over one period, rendered."""
    o = mix["orbit"]
    n_frames, cam_rate, n_imu = mix["ring_frames"], mix["cam_rate"], mix["imu_per_frame"]
    period = n_frames / cam_rate
    imu_rate = cam_rate * n_imu
    om = 2.0 * math.pi / period
    g = generator(device, seed)
    f64 = dict(dtype=torch.float64, device=device)
    phase = (2.0 * math.pi * torch.arange(agents, **f64) / agents
             + 2.0 * math.pi * torch.rand((), generator=g, **f64))[:, None]  # (A, 1)
    pos, vel, acc, rot = orbit(o, om, phase)

    # IMU samples 1 .. L * n of the period (sample L * n is t = T, i.e. sample 0 of the next)
    s = torch.arange(1, n_frames * n_imu + 1, **f64)
    t_imu = (s / imu_rate)[None, :]  # (1, S)
    hfd = 0.5 / imu_rate
    dr = rot(t_imu - hfd).transpose(-1, -2) @ rot(t_imu + hfd)
    ang = torch.arccos(torch.clamp((dr.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0, -1.0, 1.0))
    sc = torch.where(ang > 1e-12, ang / torch.clamp(torch.sin(ang), min=1e-12), 1.0)
    w_body = (torch.stack([dr[..., 2, 1] - dr[..., 1, 2], dr[..., 0, 2] - dr[..., 2, 0],
                           dr[..., 1, 0] - dr[..., 0, 1]], -1) * (sc / 2.0)[..., None] / (2 * hfd))
    grav = torch.tensor(GRAVITY, **f64)
    a_body = (rot(t_imu).transpose(-1, -2) @ (acc(t_imu) - grav)[..., None])[..., 0]
    w_m = w_body + o["imu_noise_w"] * torch.randn(w_body.shape, generator=g, **f64)
    a_m = a_body + o["imu_noise_a"] * torch.randn(a_body.shape, generator=g, **f64)

    def per_frame(x):  # (A, S, ...) -> (L, A, n, ...)
        return x.reshape((agents, n_frames, n_imu) + x.shape[2:]).transpose(0, 1).contiguous()

    times = per_frame(t_imu.expand(agents, -1)).to(torch.float32)
    seqs = per_frame(s[None].expand(agents, -1)).to(torch.int32)
    tex = texture(mix["texture_seed"], mix["texture_size"], device)
    cam_t = (torch.arange(n_frames, **f64) + 1) / cam_rate
    p_all, r_all = pos(cam_t[None]), rot(cam_t[None])  # (A, L, 3), (A, L, 3, 3)
    frames = torch.empty((n_frames, agents, h, w), dtype=torch.float32, device=device)
    for k in range(n_frames):
        frames[k] = render(tex, p_all[:, k], r_all[:, k], h, w, 0.8 * w)
    t0 = torch.zeros((1, 1), **f64)
    start = (pos(t0)[:, 0], vel(t0)[:, 0], rot_to_quat(rot(t0))[:, 0])
    return Ring(period, n_imu, frames, times, seqs, per_frame(w_m).to(torch.float32),
                per_frame(a_m).to(torch.float32), None, start)


def circle_ring(mix: dict, agents: int, n_matches: int, seed: int, device) -> Ring:
    """The ``matches`` input: the circle simulation over one period."""
    c = mix["circle"]
    n_frames, cam_rate, n_imu = mix["ring_frames"], mix["cam_rate"], mix["imu_per_frame"]
    period = n_frames / cam_rate
    imu_rate = cam_rate * n_imu
    om, r = 2.0 * math.pi / period, c["radius"]
    g = generator(device, seed)
    f64 = dict(dtype=torch.float64, device=device)
    n_lm = c["landmarks"]
    u = torch.rand((n_lm, 3), generator=g, **f64)
    lm = torch.stack([-4 + 8 * u[:, 0], -4 + 8 * u[:, 1], 5 + 4 * u[:, 2]], -1)

    def pos(t):
        a = om * t
        return torch.stack([r * torch.sin(a), r * (1 - torch.cos(a)), 0 * t], -1)

    def acc(t):
        a = om * t
        return torch.stack([-r * om ** 2 * torch.sin(a), r * om ** 2 * torch.cos(a), 0 * t], -1)

    s = torch.arange(1, n_frames * n_imu + 1, **f64)
    t_imu = s / imu_rate
    a_true = acc(t_imu) - torch.tensor(GRAVITY, **f64)  # identity attitude: specific force
    shape = (n_frames, agents, n_imu, 3)
    a_m = a_true.reshape(n_frames, 1, n_imu, 3) + c["imu_jitter"] * torch.randn(shape, generator=g, **f64)
    w_m = c["imu_jitter"] * torch.randn(shape, generator=g, **f64)

    def project(p):  # (L, 3) -> (L, n_lm, 2)
        rel = lm[None] - p[:, None]
        return rel[..., :2] / rel[..., 2:3]

    cam_t = (torch.arange(n_frames, **f64) + 1) / cam_rate
    cur = project(pos(cam_t))
    prev = torch.roll(cur, 1, dims=0)  # frame 0's previous view is the period's last (t = 0)
    nn = min(n_lm, n_matches)
    j = n_matches
    ids = torch.full((n_frames, agents, j), -1, dtype=torch.int32, device=device)
    ids[:, :, :nn] = torch.arange(nn, dtype=torch.int32, device=device)
    pts = torch.zeros((2, n_frames, agents, j, 2), **f64)
    pts[0, :, :, :nn] = prev[:, None, :nn]
    pts[1, :, :, :nn] = cur[:, None, :nn]
    pts[:, :, :, :nn] += c["pixel_noise"] * torch.randn((2, n_frames, 1, nn, 2), generator=g, **f64)
    pts += c["match_jitter"] * torch.randn(pts.shape, generator=g, **f64)
    valid = (ids >= 0) & (torch.rand((n_frames, agents, j), generator=g, **f64) > c["churn"])
    times = t_imu.reshape(n_frames, 1, n_imu).expand(n_frames, agents, n_imu)
    seqs = s.reshape(n_frames, 1, n_imu).expand(n_frames, agents, n_imu)
    matches = {"track_id": ids, "prev_pt": pts[0].to(torch.float32),
               "cur_pt": pts[1].to(torch.float32), "valid": valid}
    zero = torch.zeros((agents, 3), **f64)
    v0 = zero.clone()
    v0[:, 0] = r * om
    q0 = torch.zeros((agents, 4), **f64)
    q0[:, 3] = 1.0
    return Ring(period, n_imu, None, times.to(torch.float32).contiguous(),
                seqs.to(torch.int32).contiguous(), w_m.to(torch.float32), a_m.to(torch.float32),
                matches, (zero, v0, q0))


def make_ring(mix: dict, agents: int, config: dict, seed: int, device) -> Ring:
    if mix["input"] == "image":
        return orbit_ring(mix, agents, config["image"]["height"], config["image"]["width"], seed,
                          device)
    if mix["input"] == "matches":
        return circle_ring(mix, agents, config["vio"]["cfg"]["tracks"]["n_matches"], seed, device)
    raise ValueError(f"unknown input kind {mix['input']!r}")
