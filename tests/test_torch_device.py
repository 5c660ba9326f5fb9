"""The port's default device is the card: every entry point and state
constructor that takes ``device`` resolves ``None`` to CUDA
(``x_multi_agent_torch.device.resolve``) and raises where there is no card,
asking for ``device="cpu"``; with ``device="cpu"`` each runs on the CPU.
"""
import numpy as np
import pytest
import torch

from x_multi_agent_torch import configs
from x_multi_agent_torch.device import resolve
from x_multi_agent_torch.ekf import buffer, state
from x_multi_agent_torch.ops import lie
from x_multi_agent_torch.parallel import collab, match_store
from x_multi_agent_torch.photometric import calib
from x_multi_agent_torch.utils import ref_ingest, scene
from x_multi_agent_torch.utils.collab_eval import run_collab_gain
from x_multi_agent_torch.vio import pipeline, vio
from x_multi_agent_torch.vio import track_manager as tm
from x_multi_agent_torch.vision import tracker

PARAMS = configs.flagship_params(small=True)
DIMS = PARAMS.cfg.dims

# each builds its object with the given keywords (none, or device="cpu") and
# returns the device it landed on
BUILDERS = {
    "VIO": lambda **kw: vio.VIO(PARAMS, **kw).device,
    "init_at_time": lambda **kw: vio.init_at_time(PARAMS, 0.0, 2, kw.get("device"))[0].cov.device,
    "make_initial_covariance": lambda **kw: vio.make_initial_covariance(PARAMS, **kw).device,
    "TrackerState.zero": lambda **kw: tracker.TrackerState.zero(
        configs.flagship_tracker(PARAMS.cfg.tracks.n_matches), 2, 16, 16, **kw).pts.device,
    "make_texture": lambda **kw: scene.make_texture(0, size=64, **kw).device,
    "CoreState.zero": lambda **kw: state.CoreState.zero(2, **kw).p.device,
    "VisionState.zero": lambda **kw: state.VisionState.zero(DIMS, 2, **kw).p_arr.device,
    "FilterState.zero": lambda **kw: state.FilterState.zero(DIMS, 2, **kw).cov.device,
    "empty_buffer": lambda **kw: buffer.empty_buffer(2, 8, **kw).device,
    "KfMeta.zero": lambda **kw: collab.KfMeta.zero(2, **kw).last_kf_pos.device,
    "FrameDebug.zero": lambda **kw: pipeline.FrameDebug.zero(PARAMS.cfg, 2, **kw).new_cur.device,
    "MatchStore.zero": lambda **kw: match_store.MatchStore.zero(
        DIMS, match_store.StoreDims(), 2, **kw).own_id.device,
    "TrackSlots.zero": lambda **kw: tm.TrackSlots.zero(PARAMS.cfg.tracks, 2, **kw).slam_id.device,
    "Matches.zero": lambda **kw: tm.Matches.zero(PARAMS.cfg.tracks, 2, **kw).valid.device,
    "quat_identity": lambda **kw: lie.quat_identity(**kw).device,
    "PhotoState.zero": lambda **kw: calib.PhotoState.zero(calib.PhotoDims(), **kw).params_pt.device,
    "thermal_vignette": lambda **kw: scene.thermal_vignette(8, 8, 0.06, **kw).device,
    "to_device_matches": lambda **kw: ref_ingest.to_device_matches(
        ref_ingest.import_matches(np.arange(10.0), configs.flagship_camera(16, 16)), 4,
        **kw).cur_pt.device,
}


def _no_card_raises(fn):
    """Without a device: CUDA where there is a card, else a RuntimeError that
    names the CPU spelling."""
    if torch.cuda.is_available():
        assert fn().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()


def test_resolve():
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")
    _no_card_raises(resolve)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_constructor_defaults_to_the_card(name):
    build = BUILDERS[name]
    _no_card_raises(build)
    assert build(device="cpu").type == "cpu"


def test_run_collab_gain_defaults_to_the_card():
    """Without a device it asks for one before any work; with the CPU it runs
    the experiment (one exchange round on a short simulation)."""
    from x_multi_agent_tpu.utils.sim import make_circle_sim  # numpy only

    sim = make_circle_sim(duration=0.6, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                          match_budget=PARAMS.cfg.tracks.n_matches, pixel_noise=5e-4, seed=1)
    params = PARAMS._replace(dtype="float64")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run_collab_gain(params, collab.CollabConfig(), sim)
    got = run_collab_gain(params, collab.CollabConfig(), sim, device="cpu")
    assert got.n_rounds == 1
    assert np.isfinite([got.ate_solo, got.ate_collab, got.ate_helper]).all()
