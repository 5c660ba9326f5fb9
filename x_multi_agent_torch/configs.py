"""The flagship configuration, as the reference's entry module
(``__graft_entry__._params``) and its image benchmark (``bench.py``,
``bench_image``) define it: filter dims, track budgets, tracker settings and
camera.
"""
from __future__ import annotations

from .ekf.state import StateDims
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
