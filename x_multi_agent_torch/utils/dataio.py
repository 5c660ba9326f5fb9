"""Dataset IO for EuRoC/ASL-style directories (port of the numpy readers of
``x_multi_agent_tpu.utils.dataio``; host-side, no device work)::

    dataset/
      imu.csv           # t, wx, wy, wz, ax, ay, az  ('#' comments ok)
      cam/
        data.csv        # t, filename
        <frames>.pgm
"""
from __future__ import annotations

import os
from typing import List, NamedTuple

import numpy as np


def load_imu_csv(path: str) -> np.ndarray:
    """(N, 7): t, wx, wy, wz, ax, ay, az (rows with fewer fields skipped)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            if len(parts) >= 7:
                rows.append([float(x) for x in parts[:7]])
    return np.asarray(rows, np.float64)


def load_pgm(path: str) -> np.ndarray:
    """(H, W) uint8 of a binary (P5) PGM; header comments allowed."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P5"):
        raise IOError(f"not a binary PGM: {path}")
    vals = []
    i = 2
    while len(vals) < 3:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while data[j : j + 1].isdigit():
            j += 1
        vals.append(int(data[i:j]))
        i = j
    i += 1
    w, h, _ = vals
    return np.frombuffer(data, np.uint8, w * h, i).reshape(h, w).copy()


def load_pgm_batch(paths: List[str]) -> np.ndarray:
    """(N, H, W) uint8, decoded one after another."""
    return np.stack([load_pgm(p) for p in paths])


class Dataset(NamedTuple):
    imu_t: np.ndarray  # (Ni,) seconds
    imu_w: np.ndarray  # (Ni, 3)
    imu_a: np.ndarray  # (Ni, 3)
    cam_t: np.ndarray  # (Nc,) seconds
    cam_paths: List[str]


def load_euroc_style(root: str, time_scale: float = 1e-9) -> Dataset:
    """EuRoC layout: timestamps in ns by default (``time_scale`` converts)."""
    imu = load_imu_csv(os.path.join(root, "imu.csv"))
    cam_t, cam_paths = [], []
    with open(os.path.join(root, "cam", "data.csv")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t_str, name = line.split(",")[:2]
            cam_t.append(float(t_str) * time_scale)
            cam_paths.append(os.path.join(root, "cam", name.strip()))
    return Dataset(imu_t=imu[:, 0] * time_scale, imu_w=imu[:, 1:4], imu_a=imu[:, 4:7],
                   cam_t=np.asarray(cam_t), cam_paths=cam_paths)
