"""FOV-model camera (port of ``x_multi_agent_tpu.vision.camera``).

Intrinsics are fractional (fx is a fraction of image width etc.).
Distortion is the FOV model: undistortion of a radial distance r is
tan(r * s) / (2 tan(s/2)), applied only for r > 0.01.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Camera(NamedTuple):
    fx: float  # pixels
    fy: float
    cx: float
    cy: float
    s: float  # FOV parameter; 0 = no distortion
    width: int
    height: int

    @staticmethod
    def from_fractional(fx, fy, cx, cy, s, width, height) -> "Camera":
        return Camera(fx * width, fy * height, cx * width, cy * height, s, width, height)

    @property
    def inv_fx(self):
        return 1.0 / self.fx

    @property
    def inv_fy(self):
        return 1.0 / self.fy


def undistort(cam: Camera, pts_dist: torch.Tensor) -> torch.Tensor:
    """Distorted pixel coords (..., 2) -> undistorted pixel coords."""
    x = pts_dist[..., 0] * (1.0 / cam.fx) - cam.cx / cam.fx
    y = pts_dist[..., 1] * (1.0 / cam.fy) - cam.cy / cam.fy
    r = torch.sqrt(x * x + y * y)
    if cam.s == 0.0:
        factor = torch.ones_like(r)
    else:
        s_term = 1.0 / (2.0 * math.tan(cam.s / 2.0))
        safe_r = torch.where(r > 0.01, r, torch.ones_like(r))
        factor = torch.where(
            r > 0.01, torch.tan(safe_r * cam.s) * s_term / safe_r, torch.ones_like(r)
        )
    xn = factor * x
    yn = factor * y
    return torch.stack([xn * cam.fx + cam.cx, yn * cam.fy + cam.cy], dim=-1)


def normalize(cam: Camera, pts: torch.Tensor) -> torch.Tensor:
    """Pixel coords -> normalized image-plane coords."""
    x = pts[..., 0] / cam.fx - cam.cx / cam.fx
    y = pts[..., 1] / cam.fy - cam.cy / cam.fy
    return torch.stack([x, y], dim=-1)


def denormalize(cam: Camera, pts_n: torch.Tensor) -> torch.Tensor:
    x = (pts_n[..., 0] + cam.cx / cam.fx) * cam.fx
    y = (pts_n[..., 1] + cam.cy / cam.fy) * cam.fy
    return torch.stack([x, y], dim=-1)
