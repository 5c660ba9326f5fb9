"""Debug-image rendering on the host (port of
``x_multi_agent_tpu.utils.render``): the tracker's match plot, the track
manager's feature classes with a colour legend and counts, the range
finder's facet overlay and the cross-agent match plot, as numpy raster
primitives drawing the reference's pixels.

The debug payload is the port's ``pipeline.FrameDebug`` (agent axis first);
these plots read agent 0, the single-agent facade's. Points are normalized
undistorted camera coordinates; pass the ``Camera`` to map them to pixels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..vision import camera as cam_mod

Color = Tuple[int, int, int]

# class colors (RGB) mirroring the reference legend roles
# (track_manager.cpp:638-731: SLAM green, MSCKF blue, opportunistic
# yellow, new candidates purple, short/dead red)
SLAM_COLOR: Color = (0, 220, 0)
MSCKF_COLOR: Color = (40, 120, 255)
OPP_COLOR: Color = (240, 200, 0)
NEW_COLOR: Color = (200, 60, 220)
SHORT_COLOR: Color = (240, 50, 50)
MATCH_COLOR: Color = (0, 255, 255)
OUTLIER_COLOR: Color = (255, 0, 0)
FACET_COLOR: Color = (255, 140, 0)

# 3x5 bitmap font for legend text (rows of 3 bits, MSB left)
_FONT = {
    "0": (7, 5, 5, 5, 7), "1": (2, 6, 2, 2, 7), "2": (7, 1, 7, 4, 7),
    "3": (7, 1, 7, 1, 7), "4": (5, 5, 7, 1, 1), "5": (7, 4, 7, 1, 7),
    "6": (7, 4, 7, 5, 7), "7": (7, 1, 1, 2, 2), "8": (7, 5, 7, 5, 7),
    "9": (7, 5, 7, 1, 7),
    "A": (2, 5, 7, 5, 5), "C": (3, 4, 4, 4, 3), "E": (7, 4, 7, 4, 7),
    "F": (7, 4, 7, 4, 4), "H": (5, 5, 7, 5, 5), "I": (7, 2, 2, 2, 7),
    "K": (5, 5, 6, 5, 5), "L": (4, 4, 4, 4, 7), "M": (5, 7, 7, 5, 5),
    "N": (5, 7, 7, 7, 5), "O": (2, 5, 5, 5, 2), "P": (7, 5, 7, 4, 4),
    "R": (7, 5, 6, 5, 5), "S": (3, 4, 2, 1, 6), "T": (7, 2, 2, 2, 2),
    "U": (5, 5, 5, 5, 7), "W": (5, 5, 7, 7, 5), "X": (5, 5, 2, 5, 5),
    " ": (0, 0, 0, 0, 0), ":": (0, 2, 0, 2, 0),
}


def to_rgb(img: np.ndarray) -> np.ndarray:
    """Grayscale (H, W) [0..1 or 0..255] (numpy, or a tensor on any
    device) -> RGB uint8 canvas."""
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 3:
        return img.astype(np.uint8).copy()
    if img.dtype != np.uint8:
        mx = float(img.max()) if img.size else 1.0
        img = (img * (255.0 if mx <= 1.5 else 1.0)).clip(0, 255).astype(np.uint8)
    return np.stack([img] * 3, axis=-1)


def draw_line(canvas: np.ndarray, p0, p1, color: Color) -> None:
    """Dense-sampled line segment (in-place)."""
    h, w = canvas.shape[:2]
    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    t = np.linspace(0.0, 1.0, n + 1)
    xs = np.round(p0[0] + t * (p1[0] - p0[0])).astype(int)
    ys = np.round(p0[1] + t * (p1[1] - p0[1])).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def draw_circle(canvas: np.ndarray, center, radius: int, color: Color,
                filled: bool = False) -> None:
    h, w = canvas.shape[:2]
    cx, cy = float(center[0]), float(center[1])
    x0, x1 = int(cx - radius - 1), int(cx + radius + 2)
    y0, y1 = int(cy - radius - 1), int(cy + radius + 2)
    x0, x1 = max(x0, 0), min(x1, w)
    y0, y1 = max(y0, 0), min(y1, h)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    if filled:
        m = d2 <= radius**2
    else:
        m = (d2 <= (radius + 0.5) ** 2) & (d2 >= (radius - 0.5) ** 2)
    canvas[y0:y1, x0:x1][m] = color


def draw_text(canvas: np.ndarray, org, text: str, color: Color,
              scale: int = 2) -> None:
    """Tiny 3x5 bitmap text at ``org`` (top-left), in-place."""
    h, w = canvas.shape[:2]
    x, y = int(org[0]), int(org[1])
    for ch in text.upper():
        rows = _FONT.get(ch)
        if rows is None:
            rows = _FONT[" "]
        for r, bits in enumerate(rows):
            for c in range(3):
                if bits & (4 >> c):
                    ys, xs = y + r * scale, x + c * scale
                    canvas[max(ys, 0):min(ys + scale, h),
                           max(xs, 0):min(xs + scale, w)] = color
        x += 4 * scale


def _to_px(camera: Optional[cam_mod.Camera], pts_n) -> np.ndarray:
    pts_n = np.asarray(pts_n, float)
    if camera is None:
        return pts_n
    return cam_mod.denormalize(camera, torch.from_numpy(pts_n)).numpy()


def _agent0(x) -> np.ndarray:
    """Agent 0 of one ``FrameDebug`` field, as numpy."""
    return x[0].cpu().numpy()


def draw_matches(img, prev_pts_n, cur_pts_n, valid,
                 camera: Optional[cam_mod.Camera] = None,
                 inlier=None) -> np.ndarray:
    """Tracker match plot (``tracker.cpp:367-388``): line prev->cur + circle
    at cur per valid match; RANSAC outliers (``inlier=False``) in red."""
    canvas = to_rgb(img)
    prev_px = _to_px(camera, prev_pts_n)
    cur_px = _to_px(camera, cur_pts_n)
    valid = np.asarray(valid, bool)
    inl = np.ones_like(valid) if inlier is None else np.asarray(inlier, bool)
    for i in np.flatnonzero(valid):
        color = MATCH_COLOR if inl[i] else OUTLIER_COLOR
        draw_line(canvas, prev_px[i], cur_px[i], color)
        draw_circle(canvas, cur_px[i], 3, color)
    return canvas


def draw_track_classes(img, debug, camera: Optional[cam_mod.Camera] = None,
                       legend: bool = True) -> np.ndarray:
    """Feature-class plot with color legend + counts
    (``track_manager.cpp:638-731``). ``debug`` is a
    :class:`..vio.pipeline.FrameDebug`."""
    canvas = to_rgb(img)
    d = debug._replace(**{k: _agent0(v) for k, v in debug._asdict().items()})
    groups = [
        ("SLAM", SLAM_COLOR, d.slam_cur, d.slam_valid, 4),
        ("MSCKF", MSCKF_COLOR, d.msckf_cur, d.msckf_valid, 4),
        ("OPP", OPP_COLOR, d.opp_cur, d.opp_valid, 2),
        ("NEW", NEW_COLOR, d.new_cur, d.new_valid, 3),
        ("SHORT", SHORT_COLOR, d.short_cur, d.short_valid, 3),
    ]
    for _, color, pts_n, valid, radius in groups:
        px = _to_px(camera, pts_n)
        for i in np.flatnonzero(valid):
            draw_circle(canvas, px[i], radius, color)
    # MSCKF chi2 outliers get a red inner dot (reference plots
    # inliers/outliers separately, vio.cpp:338-341)
    px = _to_px(camera, d.msckf_cur)
    bad = d.msckf_valid & ~d.msckf_inlier
    for i in np.flatnonzero(bad):
        draw_circle(canvas, px[i], 1, OUTLIER_COLOR, filled=True)
    if legend:
        y = 4
        for name, color, _, valid, _ in groups:
            count = int(valid.sum())
            draw_text(canvas, (4, y), f"{name}:{count}", color)
            y += 14
    return canvas


def draw_facet(img, debug, range_img_pt_n=None,
               camera: Optional[cam_mod.Camera] = None) -> np.ndarray:
    """LRF facet overlay (``track_manager.cpp:466-485``): the selected
    SLAM-feature triangle + the LRF image point."""
    canvas = to_rgb(img)
    if not bool(_agent0(debug.facet_found)):
        return canvas
    ids = _agent0(debug.facet_ids).astype(int)
    tri_n = _agent0(debug.slam_cur)[ids]
    tri = _to_px(camera, tri_n)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        draw_line(canvas, tri[a], tri[b], FACET_COLOR)
    if range_img_pt_n is not None:
        pt = _to_px(camera, np.asarray(range_img_pt_n)[None])[0]
        draw_circle(canvas, pt, 4, FACET_COLOR, filled=True)
    return canvas


def draw_cross_agent_matches(img_a, img_b, pts_a_n, pts_b_n, valid,
                             camera_a: Optional[cam_mod.Camera] = None,
                             camera_b: Optional[cam_mod.Camera] = None
                             ) -> np.ndarray:
    """Side-by-side cross-agent correspondence plot
    (``place_recognition.cpp:96-135``)."""
    ca, cb = to_rgb(img_a), to_rgb(img_b)
    h = max(ca.shape[0], cb.shape[0])
    canvas = np.zeros((h, ca.shape[1] + cb.shape[1], 3), np.uint8)
    canvas[: ca.shape[0], : ca.shape[1]] = ca
    canvas[: cb.shape[0], ca.shape[1]:] = cb
    off = np.array([ca.shape[1], 0.0])
    pa = _to_px(camera_a, pts_a_n)
    pb = _to_px(camera_b, pts_b_n) + off
    for i in np.flatnonzero(np.asarray(valid, bool)):
        draw_circle(canvas, pa[i], 3, MATCH_COLOR)
        draw_circle(canvas, pb[i], 3, MATCH_COLOR)
        draw_line(canvas, pa[i], pb[i], MATCH_COLOR)
    return canvas
