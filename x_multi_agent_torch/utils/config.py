"""Runtime configuration: a reference-format YAML file -> the port's
``VioParams`` (port of ``x_multi_agent_tpu.utils.config``).

The key names are the reference loader's; quaternions in the YAML are
(w, x, y, z), everything inside is xyzw. The reference's compile-time feature
flags become the runtime booleans of :class:`FeatureFlags`. PyYAML is
imported only when a file is loaded.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ekf.propagator import ImuNoise
from ..ekf.state import StateDims
from ..vio.pipeline import VioConfig
from ..vio.track_manager import TrackDims
from ..vio.vio import VioParams


class FeatureFlags(NamedTuple):
    multi_uav: bool = False
    request_comm: bool = False
    photometric_cali: bool = False
    gt_debug: bool = False


class CameraParams(NamedTuple):
    """FOV-model camera: fractional fx/fy/cx/cy are multiplied by the image
    size."""

    fx: float = 0.5  # fraction of width
    fy: float = 0.5  # fraction of height
    cx: float = 0.5
    cy: float = 0.5
    s: float = 0.0  # FOV distortion parameter
    width: int = 640
    height: int = 480

    @property
    def fx_px(self):
        return self.fx * self.width

    @property
    def fy_px(self):
        return self.fy * self.height


class FullParams(NamedTuple):
    """Everything of the reference's parameter struct that the port uses."""

    vio: VioParams = VioParams()
    camera: CameraParams = CameraParams()
    flags: FeatureFlags = FeatureFlags()
    # tracker parameters (the vision front end)
    fast_detection_delta: int = 9
    non_max_supp: bool = True
    block_half_length: int = 20
    margin: int = 20
    n_feat_min: int = 80
    outlier_method: int = 8
    outlier_param1: float = 0.3
    outlier_param2: float = 0.99
    win_size_w: int = 31
    win_size_h: int = 31
    max_level: int = 2
    min_eig_thr: float = 0.003
    n_tiles_h: int = 1
    n_tiles_w: int = 1
    max_feat_per_tile: int = 40
    time_offset: float = 0.0
    # initial state
    p0: tuple = (0.0, 0.0, 0.0)
    v0: tuple = (0.0, 0.0, 0.0)
    q0: tuple = (0.0, 0.0, 0.0, 1.0)  # xyzw
    b_w0: tuple = (0.0, 0.0, 0.0)
    b_a0: tuple = (0.0, 0.0, 0.0)


def _wxyz_to_xyzw(q):
    q = np.asarray(q, float)
    q = q / np.linalg.norm(q)
    return (q[1], q[2], q[3], q[0])


def _vec(x):
    return tuple(np.asarray(x, float))


def load_params_from_yaml(path: str, dtype: str = "float32") -> FullParams:
    """Load a reference-format YAML parameter file."""
    import yaml

    with open(path) as f:
        y = yaml.safe_load(f)
    get = y.get
    dims = StateDims(
        n_poses=int(get("n_poses_max", 15)),
        n_features=int(get("n_slam_features_max", 15)),
        buffer_size=int(get("state_buffer_size", 250)),
    )
    cam = CameraParams(
        fx=float(get("cam1_fx", 0.5)), fy=float(get("cam1_fy", 0.5)),
        cx=float(get("cam1_cx", 0.5)), cy=float(get("cam1_cy", 0.5)),
        s=float(get("cam1_s", 0.0)),
        width=int(get("cam1_img_width", 640)), height=int(get("cam1_img_height", 480)),
    )
    msckf_baseline = float(get("msckf_baseline", 10.0))
    cfg = VioConfig(
        dims=dims,
        tracks=TrackDims(
            n_slam=dims.n_features, n_poses=dims.n_poses,
            n_opp=int(get("n_tiles_h", 1)) * int(get("n_tiles_w", 1))
            * int(get("max_feat_per_tile", 40)),
            n_matches=200,
        ),
        q_ic=_wxyz_to_xyzw(get("cam1_q_ic", [1, 0, 0, 0])),
        p_ic=_vec(get("cam1_p_ic", [0, 0, 0])),
        sigma_img=float(get("sigma_img", 0.005)),
        sigma_range=float(get("sigma_range", 0.05)),
        rho_0=float(get("rho_0", 0.5)),
        sigma_rho_0=float(get("sigma_rho_0", 0.25)),
        min_track_length=int(get("min_track_length", 15)),
        iekf_iter=int(get("iekf_iter", 1)),
        msckf_baseline_x_n=msckf_baseline / cam.fx_px,
        msckf_baseline_y_n=msckf_baseline / cam.fy_px,
    )
    vio = VioParams(
        cfg=cfg,
        g=_vec(get("g", [0, 0, -9.81])),
        imu_noise=ImuNoise(
            n_w=float(get("n_w", 0.0083)), n_bw=float(get("n_bw", 0.00083)),
            n_a=float(get("n_a", 0.0013)), n_ba=float(get("n_ba", 0.00013)),
        ),
        sigma_dp=_vec(get("sigma_dp", [0, 0, 0])),
        sigma_dv=_vec(get("sigma_dv", [0.05] * 3)),
        sigma_dtheta_deg=_vec(get("sigma_dtheta", [3.0] * 3)),
        sigma_dbw_deg=_vec(get("sigma_dbw", [6.0] * 3)),
        sigma_dba=_vec(get("sigma_dba", [0.3] * 3)),
        dtype=dtype,
    )
    return FullParams(
        vio=vio,
        camera=cam,
        fast_detection_delta=int(get("fast_detection_delta", 9)),
        non_max_supp=bool(get("non_max_supp", True)),
        block_half_length=int(get("block_half_length", 20)),
        margin=int(get("margin", 20)),
        n_feat_min=int(get("n_feat_min", 80)),
        outlier_method=int(get("outlier_method", 8)),
        outlier_param1=float(get("outlier_param1", 0.3)),
        outlier_param2=float(get("outlier_param2", 0.99)),
        win_size_w=int(get("win_size_w", 31)),
        win_size_h=int(get("win_size_h", 31)),
        max_level=int(get("max_level", 2)),
        min_eig_thr=float(get("min_eig_thr", 0.003)),
        n_tiles_h=int(get("n_tiles_h", 1)),
        n_tiles_w=int(get("n_tiles_w", 1)),
        max_feat_per_tile=int(get("max_feat_per_tile", 40)),
        time_offset=float(get("cam1_time_offset", 0.0)),
        p0=_vec(get("p", [0, 0, 0])),
        v0=_vec(get("v", [0, 0, 0])),
        q0=_wxyz_to_xyzw(get("q", [1, 0, 0, 0])),
        b_w0=_vec(get("b_w", [0, 0, 0])),
        b_a0=_vec(get("b_a", [0, 0, 0])),
    )
