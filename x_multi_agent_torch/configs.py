"""The flagship configuration, as the reference's entry module
(``__graft_entry__._params``) and its image benchmark (``bench.py``,
``bench_image``) define it: filter dims, track budgets, tracker settings and
camera; and the collaborative-gain experiment's configuration, as the
reference's ``tests/test_collab.py`` defines it (``PARAMS``, ``CCFG``) for
its ``scripts/collab_gain_report.py``.
"""
from __future__ import annotations

from .ekf.state import StateDims
from .parallel.collab import CollabConfig
from .vio import pipeline
from .vio import track_manager as tm
from .vio.vio import VioParams
from .vision.camera import Camera
from .vision.tracker import TrackerParams


def flagship_params(small: bool = False) -> VioParams:
    """M=15 poses, N=15 features, buffer 250 (D=150), 200 matches per frame;
    ``small`` gives the 6/6/32 test size with 24 matches. No range or sun
    sensor. float32, update lag 16 IMU samples."""
    if small:
        dims = StateDims(n_poses=6, n_features=6, buffer_size=32)
        tracks = tm.TrackDims(
            n_slam=6, n_poses=6, n_opp=16, n_matches=24, n_msckf=4, n_short=4, n_new_slam=6,
        )
    else:
        dims = StateDims(n_poses=15, n_features=15, buffer_size=250)
        tracks = tm.TrackDims(
            n_slam=15, n_poses=15, n_opp=60, n_matches=200, n_msckf=10, n_short=5,
            n_new_slam=15,
        )
    cfg = pipeline.VioConfig(
        dims=dims, tracks=tracks, min_track_length=min(5, dims.n_poses),
        enable_range=False, enable_sun=False,
    )
    return VioParams(cfg=cfg, dtype="float32", max_update_lag=16)


def flagship_tracker(n_matches: int) -> TrackerParams:
    """The image benchmark's tracker: FAST on two pyramid levels, 3-level LK
    with 21x21 windows, 4x4 detection tiles of at most 40 candidates."""
    return TrackerParams(
        budget=n_matches, fast_threshold=12.0, n_feat_min=max(60, n_matches // 3),
        n_tiles_h=4, n_tiles_w=4, max_feat_per_tile=40, block_half_length=12, margin=12,
        pyramid_depth=2, win_half=10, lk_max_level=2, ransac_threshold_px=1.0,
    )


def flagship_camera(h: int, w: int) -> Camera:
    return Camera.from_fractional(0.8, 0.8 * w / h, 0.5, 0.5, 0.0, w, h)


def collab_gain_params() -> VioParams:
    """The collaborative-gain experiment's filter (the reference's
    ``tests/test_collab.py`` ``PARAMS``): 8 poses, 8 SLAM features, buffer
    64, 60 matches per frame, sigma_img 2e-3, 5-frame tracks, MSCKF baseline
    gates 0.01, no observability constraint; float64, update lag 32, a
    tighter initial attitude, gyro-bias and accel-bias prior."""
    dims = StateDims(n_poses=8, n_features=8, buffer_size=64)
    tracks = tm.TrackDims(n_slam=8, n_poses=8, n_opp=40, n_matches=60, n_msckf=8, n_short=6,
                          n_new_slam=8)
    cfg = pipeline.VioConfig(dims=dims, tracks=tracks, sigma_img=2e-3, min_track_length=5,
                             msckf_baseline_x_n=0.01, msckf_baseline_y_n=0.01,
                             obs_constrained=False)
    return VioParams(cfg=cfg, dtype="float64", max_update_lag=32, sigma_dv=(0.05, 0.05, 0.05),
                     sigma_dtheta_deg=(1.0, 1.0, 1.0), sigma_dbw_deg=(1.0, 1.0, 1.0),
                     sigma_dba=(0.05, 0.05, 0.05))


def collab_gain_ccfg() -> CollabConfig:
    """The experiment's exchange (the reference's ``tests/test_collab.py``
    ``CCFG``): the conservative CI regime, peer weight 0.05, landmark sigma
    0.1 m, a 0.6 m proximity gate, 8 matches per peer."""
    return CollabConfig(sigma_landmark=0.1, ci_slam_w=0.05, gt_match_dist=0.6, match_budget=8)
