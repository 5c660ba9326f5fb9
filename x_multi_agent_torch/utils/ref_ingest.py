"""Reference-format data ingestion (port of
``x_multi_agent_tpu.utils.ref_ingest``).

1. The 10-double match-vector import::

       block i (10 doubles):
         0: cam_id
         1: time_prev [s]   2: x_dist_prev [px]   3: y_dist_prev [px]
         4: time_curr [s]   5: x_dist_curr [px]   6: y_dist_curr [px]
         7,8,9: 3D landmark (ground-truth builds only; NaN/zeros otherwise)

   Both features are undistorted through the FOV camera and normalized.
   The reference associates a match to the track whose last feature EQUALS
   the match's previous feature; the port's track manager is id-based, so
   :class:`MatchAssociator` does the equality association on the host and
   hands stable ids to the device.

2. A dataset-directory loader (:func:`load_reference_dataset`): ``imu.csv``,
   ``matches.csv`` (rows ``seq, <10 doubles per match...>``) and an optional
   ``gt.csv`` (``t, px, py, pz, qx, qy, qz, qw``).
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from ..vision import camera as cam_mod

BLOCK = 10  # doubles per match


class RefMatches(NamedTuple):
    """One frame of imported matches (host-side, ragged)."""

    cam_id: np.ndarray  # (J,) int
    time_prev: np.ndarray  # (J,)
    time_curr: np.ndarray  # (J,)
    prev_n: np.ndarray  # (J, 2) normalized undistorted coords
    cur_n: np.ndarray  # (J, 2)
    landmarks: np.ndarray  # (J, 3) ground-truth landmark (NaN when absent)
    track_id: np.ndarray  # (J,) stable ids from the associator


class MatchAssociator:
    """Feature-equality track association: a match continues the track
    whose last current feature equals the match's previous feature (same
    camera, timestamp and distorted pixel coordinates, quantized to 1e-6 so
    round trips through files stay stable); tracks not continued in a frame
    die."""

    def __init__(self):
        self._last: Dict[Tuple[int, int, int, int], int] = {}
        self._next_id = 0

    @staticmethod
    def _key(cam_id: float, t: float, x: float, y: float):
        return (int(cam_id), int(round(t * 1e6)), int(round(x * 1e6)), int(round(y * 1e6)))

    def associate(self, vec: np.ndarray) -> np.ndarray:
        """vec: (J, 10) match blocks of ONE frame -> (J,) stable ids."""
        vec = np.asarray(vec, np.float64).reshape(-1, BLOCK)
        ids = np.empty(vec.shape[0], np.int64)
        new_last: Dict[Tuple[int, int, int, int], int] = {}
        for i, row in enumerate(vec):
            tid = self._last.get(self._key(row[0], row[1], row[2], row[3]))
            if tid is None:
                tid = self._next_id
                self._next_id += 1
            ids[i] = tid
            new_last[self._key(row[0], row[4], row[5], row[6])] = tid
        self._last = new_last
        return ids


def import_matches(match_vector, camera: cam_mod.Camera,
                   assoc: Optional[MatchAssociator] = None) -> RefMatches:
    """Parse one frame's 10-double match vector; both features undistorted
    and normalized (float64, on the host)."""
    vec = np.asarray(match_vector, np.float64).reshape(-1, BLOCK)
    if vec.size and vec.shape[0] * BLOCK != np.asarray(match_vector).size:
        raise ValueError("match vector length is not a multiple of 10")

    def norm(px):
        pts = torch.from_numpy(np.ascontiguousarray(px))
        return cam_mod.normalize(camera, cam_mod.undistort(camera, pts)).numpy()

    ids = assoc.associate(vec) if assoc is not None else np.arange(vec.shape[0], dtype=np.int64)
    return RefMatches(
        cam_id=vec[:, 0].astype(np.int64), time_prev=vec[:, 1], time_curr=vec[:, 4],
        prev_n=norm(vec[:, 2:4]).reshape(-1, 2), cur_n=norm(vec[:, 5:7]).reshape(-1, 2),
        landmarks=vec[:, 7:10], track_id=ids,
    )


def to_device_matches(ref: RefMatches, budget: int, dtype=torch.float32, device=None):
    """Pad a frame into the fixed-budget ``track_manager.Matches`` with the
    facade's agent axis of 1, on ``device``."""
    from ..vio import track_manager as tm

    device = resolve(device)
    j = min(len(ref.track_id), budget)
    ids = np.full((1, budget), -1, np.int32)
    prev = np.zeros((1, budget, 2), np.float64)
    cur = np.zeros((1, budget, 2), np.float64)
    valid = np.zeros((1, budget), bool)
    ids[0, :j] = ref.track_id[:j]
    prev[0, :j] = ref.prev_n[:j]
    cur[0, :j] = ref.cur_n[:j]
    valid[0, :j] = True
    return tm.Matches.of(
        track_id=torch.from_numpy(ids).to(device),
        prev_pt=torch.from_numpy(prev).to(device=device, dtype=dtype),
        cur_pt=torch.from_numpy(cur).to(device=device, dtype=dtype),
        valid=torch.from_numpy(valid).to(device),
    )


class RefDataset(NamedTuple):
    imu_t: np.ndarray  # (Ni,) s
    imu_w: np.ndarray  # (Ni, 3)
    imu_a: np.ndarray  # (Ni, 3)
    frame_t: np.ndarray  # (Nf,) s, match-frame timestamps
    frames: List[RefMatches]  # per-frame imported matches
    gt_t: Optional[np.ndarray]  # (Ng,) s
    gt_p: Optional[np.ndarray]  # (Ng, 3)
    gt_q: Optional[np.ndarray]  # (Ng, 4) xyzw


def load_reference_dataset(root: str, camera: cam_mod.Camera,
                           time_scale: float = 1.0) -> RefDataset:
    """Load a reference-layout dataset directory::

        root/imu.csv       # t, wx, wy, wz, ax, ay, az
        root/matches.csv   # seq, then 10 doubles per match (ragged rows)
        root/gt.csv        # optional: t, px, py, pz, qx, qy, qz, qw

    A frame with no match takes the previous frame's time."""
    from . import dataio

    imu = dataio.load_imu_csv(os.path.join(root, "imu.csv"))
    assoc = MatchAssociator()
    frame_t: List[float] = []
    frames: List[RefMatches] = []
    with open(os.path.join(root, "matches.csv")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vec = np.asarray([float(v) for v in line.split(",")])[1:]
            if vec.size % BLOCK != 0:
                raise ValueError(f"matches.csv row has {vec.size} values (not 10N)")
            ref = import_matches(vec, camera, assoc)
            if len(ref.time_curr):
                frame_t.append(float(ref.time_curr[0]) * time_scale)
            else:
                frame_t.append(frame_t[-1] if frame_t else 0.0)
            frames.append(ref)
    gt_t = gt_p = gt_q = None
    gt_path = os.path.join(root, "gt.csv")
    if os.path.exists(gt_path):
        rows = np.loadtxt(gt_path, delimiter=",", comments="#", ndmin=2)
        gt_t, gt_p, gt_q = rows[:, 0] * time_scale, rows[:, 1:4], rows[:, 4:8]
    return RefDataset(imu_t=imu[:, 0] * time_scale, imu_w=imu[:, 1:4], imu_a=imu[:, 4:7],
                      frame_t=np.asarray(frame_t), frames=frames, gt_t=gt_t, gt_p=gt_p, gt_q=gt_q)
