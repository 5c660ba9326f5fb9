"""Dataset-replay ATE report (port of the reference's ``scripts/ate_report.py``).

Replays a multi-agent EuRoC-style thermal dataset from disk through the full
``VIO`` facade (tracker with descriptors, online photometric calibration,
health monitor), every agent solo and then all of them collaboratively with
REQUEST_COMM exchanges (a VLAD query, then a keyframe only on a hit), and
reports the SE(3)-aligned ATE, the position NEES against the [1.5, 4.5]
band, the degraded agent's collaborative gain and the bytes shipped against
a full broadcast. The function names are the reference's.

The dataset is rendered on first use (``utils/scene.py``): N agents on 6-DoF
orbits past a textured front wall and a side wall, with a baked thermal
drift, vignette and noise. Agent ``--degraded`` flies a cheap IMU. A
dataset whose ``meta.json`` holds the same ``gen_key`` is reused, whichever
package wrote it; ``XMAT_DATASET_DIR`` sets the root.

Solo results are cached on disk, keyed on a hash of the dataset, the filter
configuration and :data:`CODE_SALT` (the port's own, so a cache written by
the reference never pairs with a collaborative pass of the port). A replay
checkpoints every ``ckpt_every`` frames (``utils/checkpoint.py``, npz) and
resumes from its checkpoint; every random draw of the port is keyed on
state, so nothing else is saved.

Entry points run on the card unless ``device`` says otherwise; the CLI is
``scripts/ate_report_torch.py``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..device import resolve
from . import checkpoint, tree

DATASET_ROOT = os.environ.get("XMAT_DATASET_DIR", os.path.join(tempfile.gettempdir(),
                                                               "xmat_dataset"))

# bump when filter/tracker code changes invalidate cached solo replays
CODE_SALT = "torch-r1"

# the stable regime: linear gain/bias drift + static corner vignette + noise
THERMAL = dict(drift_a=0.004, drift_b=0.001, noise=0.006, vignette=0.06)
MOTION = dict(yaw_amp=0.10, pitch_amp=0.06, roll_amp=0.05, z_amp=0.2)

# the degraded agent's cheap IMU: factors on the gyro / accel sample noise
DEG_GYRO_FACTOR = 600.0
DEG_ACCEL_FACTOR = 50.0

# per-agent image noise (innovation-based noise identification on each
# agent's solo pass, as the reference calibrated it)
AGENT_SIGMA_IMG_PX = (14.0, 22.0, 10.0, 8.0)

NEES_BAND = (1.5, 4.5)


def ensure_dataset(n_agents: int, duration: float, h: int, w: int, degraded_idx: int = -1,
                   device=None):
    """Each agent's dataset under :data:`DATASET_ROOT` (``agent{a}_6dof_v2``):
    6-DoF orbit (seed 100 + a, phase 0.15 a), front wall + side wall at
    x = 4, the baked thermal degradation; rendered on ``device`` unless a
    ``meta.json`` with the same ``gen_key`` is there. Returns each agent's
    meta with its camera times and positions."""
    from . import scene

    metas = []
    tex = None
    for a in range(n_agents):
        deg = a == degraded_idx
        imu_w_f = DEG_GYRO_FACTOR if deg else 1.0
        imu_a_f = DEG_ACCEL_FACTOR if deg else 1.0
        gen_key = dict(duration=duration, h=h, w=w, thermal=THERMAL, motion=MOTION,
                       imu_w_f=imu_w_f, imu_a_f=imu_a_f)
        adir = os.path.join(DATASET_ROOT, f"agent{a}_6dof_v2")
        meta_p = os.path.join(adir, "meta.json")
        if os.path.exists(meta_p):
            with open(meta_p) as f:
                meta = json.load(f)
            if meta.get("gen_key") == gen_key:
                gt = np.loadtxt(os.path.join(adir, "gt.csv"), delimiter=",", comments="#")
                metas.append(dict(meta, cam_t=gt[:, 0], cam_p=gt[:, 1:4], dir=adir))
                continue
        print(f"generating agent {a} dataset ({duration:.0f}s)...", flush=True)
        if tex is None:
            tex = scene.make_texture(0, device=device)
        info = scene.generate_agent_dataset_6dof(
            adir, seed=100 + a, duration=duration, h=h, w=w, phase=0.15 * a, tex=tex,
            wall2_x=4.0, thermal=THERMAL, z_amp=MOTION["z_amp"], yaw_amp=MOTION["yaw_amp"],
            pitch_amp=MOTION["pitch_amp"], roll_amp=MOTION["roll_amp"],
            imu_noise_w=2e-4 * imu_w_f, imu_noise_a=2e-3 * imu_a_f, device=device,
        )
        meta = dict(duration=duration, h=h, w=w, fx=info["fx"], fy=info["fy"],
                    v0=list(map(float, info["v0"])), p0=list(map(float, info["p0"])),
                    q0=list(map(float, info["q0"])), gen_key=gen_key)
        with open(meta_p, "w") as f:
            json.dump(meta, f)
        metas.append(dict(meta, cam_t=info["cam_t"], cam_p=info["cam_p"], dir=adir))
    return metas


def ensure_variant_dataset(agent: int, tag: str, duration: float, thermal, motion,
                           imu_w_factor: float = 1.0, imu_a_factor: float = 1.0, *, gen_key,
                           h: int = 480, w: int = 640, device=None):
    """A variant of agent ``agent``'s dataset under :data:`DATASET_ROOT`
    (``agent{agent}_{tag}``), as the studies render theirs: the same orbit
    (seed 100 + agent, phase 0.15 agent) and walls as :func:`ensure_dataset`,
    with its own ``thermal`` degradation (``None``: none), ``motion``
    amplitudes and IMU noise factors. Rendered on ``device`` unless a
    ``meta.json`` with the same ``gen_key`` is there, whichever package
    wrote it. Returns the meta with the camera times and positions read
    from ``gt.csv``."""
    from . import scene

    adir = os.path.join(DATASET_ROOT, f"agent{agent}_{tag}")
    meta_p = os.path.join(adir, "meta.json")
    meta = None
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = json.load(f)
    if meta is None or meta.get("gen_key") != gen_key:
        print(f"generating the {tag} dataset of agent {agent} ({duration:.0f}s)...", flush=True)
        info = scene.generate_agent_dataset_6dof(
            adir, seed=100 + agent, duration=duration, h=h, w=w, phase=0.15 * agent,
            tex=scene.make_texture(0, device=device), wall2_x=4.0, thermal=thermal,
            z_amp=motion["z_amp"], yaw_amp=motion["yaw_amp"], pitch_amp=motion["pitch_amp"],
            roll_amp=motion["roll_amp"], imu_noise_w=2e-4 * imu_w_factor,
            imu_noise_a=2e-3 * imu_a_factor, device=device,
        )
        meta = dict(duration=duration, h=h, w=w, fx=info["fx"], fy=info["fy"],
                    v0=list(map(float, info["v0"])), p0=list(map(float, info["p0"])),
                    q0=list(map(float, info["q0"])), gen_key=gen_key)
        with open(meta_p, "w") as f:
            json.dump(meta, f)
    gt = np.loadtxt(os.path.join(adir, "gt.csv"), delimiter=",", comments="#")
    return dict(meta, cam_t=gt[:, 0], cam_p=gt[:, 1:4], dir=adir)


def filter_config(meta, degraded: bool, agent_idx: int = 0, overrides=None):
    """The full agent configuration (also the solo-cache key material)."""
    fc = _filter_config_base(meta, degraded, agent_idx)
    if overrides:
        fc.update(overrides)
    return fc


def _filter_config_base(meta, degraded: bool, agent_idx: int = 0):
    return dict(
        n_poses=10, n_features=10, buffer_size=128,
        n_slam=10, n_opp=40, n_matches=100, n_msckf=8, n_short=6,
        n_new_slam=10,
        # covers the rendered-thermal front end's real error, not the
        # nominal LK precision
        sigma_img_px=(
            AGENT_SIGMA_IMG_PX[agent_idx] if agent_idx < len(AGENT_SIGMA_IMG_PX) else 14.0
        ),
        min_track_length=6,
        msckf_baseline=0.02, max_update_lag=16,
        sigma_dp=0.05 if degraded else 1e-3,
        init_offset=0.0,
        fast_threshold=12.0, n_feat_min=60, win_half=10, pyramid_depth=2,
        ransac_px=1.0, obs_constrained=True,
        # the datasets' sample noise plus unmodelled front-end bias; the
        # degraded agent's position block needs the larger margin
        imu_noise_scale=18.0 if degraded else 3.0,
        # global gains only: the per-cell spatial solve destabilized tracking
        photometric=dict(n_obs=80, spatial=False, cell_px=80, spatial_every=20),
        health=dict(min_matches=8, bad_frames=15, cov_pos_max=100.0),
    )


def build_agent(meta, degraded: bool, words, ccfg, uav_id: int, collab: bool, overrides=None,
                device=None, seed: int = 0, dtype: str = "float32"):
    """One agent's facade: the filter, the tracker with descriptors, the
    photometric calibration, the health monitor and, with ``collab``, the
    collaboration with vocabulary ``words`` and ``ccfg``. ``seed`` is the
    base of every RANSAC draw the facade keys on its state; ``dtype`` the
    filter's (the reference's is float32)."""
    from ..ekf.propagator import ImuNoise
    from ..ekf.state import StateDims
    from ..vio import pipeline, track_manager as tm, vio as vio_mod
    from ..vision import camera as cam_mod, tracker as trk_mod

    fc = filter_config(meta, degraded, uav_id, overrides)
    dims = StateDims(n_poses=fc["n_poses"], n_features=fc["n_features"],
                     buffer_size=fc["buffer_size"])
    tracks = tm.TrackDims(
        n_slam=fc["n_slam"], n_poses=fc["n_poses"], n_opp=fc["n_opp"],
        n_matches=fc["n_matches"], n_msckf=fc["n_msckf"], n_short=fc["n_short"],
        n_new_slam=fc["n_new_slam"],
    )
    cfg = pipeline.VioConfig(
        dims=dims, tracks=tracks, sigma_img=fc["sigma_img_px"] / meta["fx"],
        min_track_length=fc["min_track_length"], msckf_baseline_x_n=fc["msckf_baseline"],
        msckf_baseline_y_n=fc["msckf_baseline"], obs_constrained=fc["obs_constrained"],
    )
    s = fc["imu_noise_scale"]
    noise = ImuNoise(n_w=0.0083 * s, n_bw=0.00083 * s, n_a=0.0013 * s, n_ba=0.00013 * s)
    params = vio_mod.VioParams(
        cfg=cfg, dtype=dtype, max_update_lag=fc["max_update_lag"], imu_noise=noise,
        sigma_dp=(fc["sigma_dp"],) * 3, sigma_dv=(0.05,) * 3, sigma_dtheta_deg=(1.0,) * 3,
        sigma_dbw_deg=(1.0,) * 3, sigma_dba=(0.05,) * 3,
    )
    v = vio_mod.VIO(params, device=device)
    p0 = np.asarray(meta.get("p0", np.zeros(3)), float)
    p0 = p0 + np.array([fc["init_offset"], 0.4 * fc["init_offset"], 0.0])
    v.init_at_time(0.0, p=p0, v=np.asarray(meta["v0"]),
                   q=np.asarray(meta.get("q0", [0.0, 0.0, 0.0, 1.0]), float))
    h, w = meta["h"], meta["w"]
    cam = cam_mod.Camera.from_fractional(meta["fx"] / w, meta["fy"] / h, 0.5, 0.5, 0.0, w, h)
    tparams = trk_mod.TrackerParams(
        budget=tracks.n_matches, fast_threshold=fc["fast_threshold"],
        n_feat_min=fc["n_feat_min"], n_tiles_h=4, n_tiles_w=4, max_feat_per_tile=15,
        block_half_length=12, margin=12, pyramid_depth=fc["pyramid_depth"],
        win_half=fc["win_half"], lk_max_level=2, ransac_threshold_px=fc["ransac_px"],
        compute_descriptors=True,
    )
    v.setup_tracker(tparams, cam, h, w, seed=seed)
    ph = fc["photometric"]
    if ph:
        v.enable_photometric(n_obs=ph["n_obs"], spatial=ph["spatial"], cell_px=ph["cell_px"],
                             spatial_every=ph["spatial_every"], seed=seed)
    hc = fc["health"]
    if hc:
        v.enable_health_monitor(min_matches=hc["min_matches"], max_bad_frames=hc["bad_frames"],
                                cov_pos_max=hc["cov_pos_max"])
    if collab:
        v.enable_collab(words, uav_id=uav_id, ccfg=ccfg, seed=seed)
    return v


def _aligned_ate(est: np.ndarray, gt: np.ndarray) -> float:
    """SE(3)-aligned ATE RMSE (Umeyama, no scale): global position and yaw
    are gauge-unobservable, so the raw error of a long run is mostly frame
    drift. NaN when an estimate is not finite (a diverged run)."""
    if not np.isfinite(est).all():
        return float("nan")
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    h = ec.T @ gc
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    aligned = (r @ ec.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


# a facade's replay state: its device states, then its host counters (which
# come back as Python ints: a leaked 0-d array breaks the report's JSON)
_STATES = ("fs", "slots", "_tracker_state", "photo", "_store", "_db", "_kf_meta",
           "n_collab_consumed", "_last_matches")
_COUNTERS = ("n_keyframes_selected", "n_reinits", "_bad_frames", "_grace", "_reinit_streak",
             "_healthy_frames")


def _agent_state(v, n_agents: int):
    """A checkpointable snapshot of one agent's whole replay state: the
    states, the counters, the health monitor's last covariance trace (NaN
    for none), and the re-fusion recency per peer id < ``n_agents`` as
    (present, (last id, last count, count)). The states are copies: the
    facade's are its programs' buffers, which its next frame overwrites."""
    from ..parallel import collab as collab_mod
    from ..vio import track_manager as tm

    states = [tree.map_leaves(torch.clone, getattr(v, k, None)) for k in _STATES]
    if states[-1] is None:  # before the first frame: a template of its shape
        states[-1] = tm.Matches.zero(v.params.cfg.tracks, 1, v.params.tdtype, v.device)
    counters = tuple(int(getattr(v, k, 0)) for k in _COUNTERS)
    last_tr = getattr(v, "_last_cov_tr", None)
    recency = getattr(v, "_fuse_recency", None)
    peers = ()
    if recency is not None:
        fresh = collab_mod.fresh_recency(v.slots)
        peers = tuple((p in recency, recency.get(p, fresh)) for p in range(n_agents))
    return (tuple(states), counters, float("nan") if last_tr is None else float(last_tr), peers)


def _restore_agent(v, state):
    states, counters, last_tr, peers = state
    for k, x in zip(_STATES, states):
        if x is not None:
            setattr(v, k, x)
    for k, n in zip(_COUNTERS, counters):
        setattr(v, k, int(n))
    if hasattr(v, "_last_cov_tr"):
        v._last_cov_tr = None if np.isnan(last_tr) else float(last_tr)
    if peers:
        v._fuse_recency = {p: rec for p, (present, rec) in enumerate(peers) if present}


def _exchange_round(agents, pb: int, vb: int):
    """One REQUEST_COMM round over every ordered (requester, responder)
    pair: the requester's VLAD, the responder's best unserved keyframe, and
    on a hit the requester's fusion. Returns (bytes shipped, hits, matches
    fused per requester)."""
    na = len(agents)
    nbytes, hits, fused = 0, 0, [0] * na
    for req in range(na):
        for res in range(na):
            if req == res:
                continue
            vlad = agents[req].get_descriptors()
            nbytes += vb
            payload, found = agents[res].process_other_requests(req, vlad)
            if found:
                nbytes += pb
                hits += 1
                fused[req] += agents[req].process_other_measurements(payload, uav_id=res)
    return nbytes, hits, fused


def _frame_reads(v) -> np.ndarray:
    """One agent-frame's host values in one transfer: the tail position,
    the anchor position, the position covariance block, the SLAM and
    opportunistic tracks and the tracker's valid matches, float64 (18,)."""
    counts = torch.stack([(v.slots.slam_id >= 0).sum(), (v.slots.opp_id >= 0).sum(),
                          v._last_matches.valid.sum()]).to(torch.float64)
    return torch.cat([
        v.tail_state().p[0].to(torch.float64), v.anchor_state().p[0].to(torch.float64),
        v.fs.cov[0, :3, :3].reshape(-1).to(torch.float64), counts,
    ]).cpu().numpy()


def replay(agents, metas, exchange: bool, log_every: int = 10, exchange_every: int = 10,
           trace_path: str = None, max_frames: int = None, ckpt_path: str = None,
           ckpt_every: int = 100, outage=None):
    """Interleaved frame-by-frame replay of every agent's dataset, with a
    REQUEST_COMM round after frame 10 every ``exchange_every`` frames.

    Every frame consumes the same fixed-stride IMU window (``n_per``
    samples). ``outage`` = (first, end) blacks out the camera on those
    frames. Per agent-frame: the error of the tail position, the NEES of the
    anchor position under the position covariance, the live tracks and the
    tracker's matches. Bytes: the full broadcast ships a payload to every
    peer every frame after frame 10; REQUEST_COMM ships a VLAD per pair and
    a payload per hit. ``ckpt_path``: save the replay state every
    ``ckpt_every`` frames and resume from it when it exists."""
    from ..parallel import collab as collab_mod
    from . import dataio

    data = [dataio.load_euroc_style(m["dir"], time_scale=1.0) for m in metas]
    imgs = [dataio.load_pgm_batch(d.cam_paths) for d in data]
    na = len(agents)
    n_full = min(len(d.cam_t) for d in data)
    n_frames = n_full if max_frames is None else min(n_full, max_frames)
    # estimates keep the filter's precision, as the reference's trajectories
    est_dtype = torch.empty((), dtype=agents[0].params.tdtype).numpy().dtype
    loop = dict(
        f=0, errs=np.zeros((na, n_frames)), nees=np.zeros((na, n_frames)),
        est=np.zeros((na, n_frames, 3), est_dtype), gt=np.zeros((na, n_frames, 3)),
        n_tracks=np.zeros((na, n_frames), np.int64), n_matches=np.zeros((na, n_frames), np.int64),
        rr_fused=np.zeros(na, np.int64), n_reinits=np.zeros(na, np.int64),
        bytes_rr=0, bytes_full=0, n_hits=0,
    )

    def snapshot():  # a tuple tree of tensors and Python scalars, as checkpoints hold
        return (tuple(_agent_state(v, na) for v in agents),
                tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                      for x in loop.values()))

    pb = vb = None
    if ckpt_path and os.path.exists(ckpt_path):
        states, saved = checkpoint.load(ckpt_path, snapshot())
        for v, st in zip(agents, states):
            _restore_agent(v, st)
        loop.update({k: x.numpy() if isinstance(x, torch.Tensor) else x
                     for k, x in zip(loop, saved)})
        print(f"=== resumed from checkpoint at frame {loop['f']} ===", flush=True)
    f_start = loop["f"]
    t0 = time.perf_counter()
    # fixed-stride IMU windows: every frame consumes exactly imu_rate /
    # cam_rate samples (the reference's stride, so both see the same samples)
    n_per = int(round((len(data[0].imu_t) - 1) / n_full))
    for f in range(f_start, n_frames):
        if ckpt_path and f > f_start and f % ckpt_every == 0:
            loop["f"] = f
            checkpoint.save(ckpt_path + ".tmp.npz", snapshot())
            os.replace(ckpt_path + ".tmp.npz", ckpt_path)
        for a, (v, d, m) in enumerate(zip(agents, data, metas)):
            t_cam = float(d.cam_t[f])
            i = f * n_per + 1
            j = min(i + n_per, len(d.imu_t))
            if j > i:
                v.process_imu_batch(d.imu_t[i:j], np.arange(i, j), d.imu_w[i:j], d.imu_a[i:j])
            img_f = imgs[a][f]
            if outage is not None and outage[0] <= f < outage[1]:
                img_f = np.zeros_like(img_f)  # total camera blackout
            v.process_image_measurement(t_cam, f, img_f)
            loop["n_reinits"][a] = getattr(v, "n_reinits", 0)
            r = _frame_reads(v)
            p_est, p_anchor, cov_p = r[:3], r[3:6], r[6:15].reshape(3, 3)
            p_gt = m["cam_p"][f]
            loop["errs"][a, f] = np.linalg.norm(p_est - p_gt)
            loop["est"][a, f] = p_est
            loop["gt"][a, f] = p_gt
            loop["n_tracks"][a, f] = int(r[15]) + int(r[16])
            loop["n_matches"][a, f] = int(r[17])
            e = p_anchor - p_gt
            try:
                loop["nees"][a, f] = float(e @ np.linalg.solve(cov_p, e))
            except np.linalg.LinAlgError:
                loop["nees"][a, f] = np.nan
        if exchange and f > 10:
            if pb is None:  # payload wire sizes are static per configuration
                pb = collab_mod.payload_nbytes(agents[0].get_data_to_send())
                vb = collab_mod.vlad_nbytes(agents[0]._words)
            # the baseline: the reference's full-exchange mode ships its
            # payload to every peer at every visual update
            loop["bytes_full"] += pb * na * (na - 1)
            if f % exchange_every == exchange_every - 1:
                nbytes, hits, fused = _exchange_round(agents, pb, vb)
                loop["bytes_rr"] += nbytes
                loop["n_hits"] += hits
                loop["rr_fused"] += np.asarray(fused, np.int64)
        if f % log_every == log_every - 1:
            print(
                f"frame {f+1}/{n_frames} errs={[round(float(e), 3) for e in loop['errs'][:, f]]} "
                f"nees={[round(float(x), 1) for x in loop['nees'][:, f]]} "
                f"trk={loop['n_tracks'][:, f].tolist()} mt={loop['n_matches'][:, f].tolist()} "
                f"fused={loop['rr_fused'].tolist()} reinit={loop['n_reinits'].tolist()} "
                f"hits={loop['n_hits']} ({time.perf_counter()-t0:.0f}s)",
                flush=True,
            )
    # NEES statistics skip the first second: right after init the position
    # covariance is the near-zero prior while the front end's error is
    # already ~1 cm, which says nothing about consistency
    skip = min(10, max(0, n_frames - 1))
    errs, nees = loop["errs"], loop["nees"]
    out = dict(
        ate=[float(np.sqrt(np.mean(np.square(e)))) for e in errs],
        ate_aligned=[_aligned_ate(e, g) for e, g in zip(loop["est"], loop["gt"])],
        final_err=[float(e[-1]) for e in errs],
        mean_nees=[float(np.nanmean(n[skip:])) for n in nees],
        max_nees=[float(np.nanmax(n[skip:])) for n in nees],
        rr_fused=[int(x) for x in loop["rr_fused"]],
        n_reinits=[int(x) for x in loop["n_reinits"]],
        n_hits=int(loop["n_hits"]),
        bytes_rr=int(loop["bytes_rr"]),
        bytes_full=int(loop["bytes_full"]),
        wall_s=round(time.perf_counter() - t0, 1),
    )
    if trace_path:
        np.savez_compressed(trace_path, err=errs, nees=nees, est=loop["est"], gt=loop["gt"],
                            n_tracks=loop["n_tracks"], n_matches=loop["n_matches"])
    return out


def solo_cache_key(meta, degraded: bool, agent_idx: int = 0, seed: int = 0) -> str:
    key = dict(salt=CODE_SALT, gen_key=meta["gen_key"],
               fc=filter_config(meta, degraded, agent_idx), seed=seed)
    return hashlib.sha1(json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]


def replay_dataset_dir(root: str, sigma_img_px: float = 14.0, max_frames: int = None,
                       device=None):
    """Drive the filter through a reference-layout dataset directory
    (``imu.csv``, ``matches.csv`` in the 10-double block format, optional
    ``gt.csv``). The camera intrinsics come from the directory's
    ``meta.json`` (fx/fy/cx/cy/s/width/height, pixel units) or default to
    the synthetic harness's camera. No image, so no kernel."""
    from ..ekf.state import StateDims
    from ..vio import pipeline as pipe_mod, track_manager as tm_mod, vio as vio_mod
    from ..vision import camera as cam_mod
    from . import ref_ingest

    device = resolve(device)
    meta_p = os.path.join(root, "meta.json")
    cam_kv = dict(fx=512.0, fy=512.0, cx=320.0, cy=240.0, s=0.0, width=640, height=480)
    v0 = None
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            m = json.load(f)
        for k in cam_kv:
            if k in m:
                cam_kv[k] = m[k]
        v0 = np.asarray(m["v0"]) if "v0" in m else None
    cam = cam_mod.Camera(**cam_kv)
    ds = ref_ingest.load_reference_dataset(root, cam)

    dims = StateDims(n_poses=10, n_features=10, buffer_size=128)
    tracks = tm_mod.TrackDims(n_slam=10, n_poses=10, n_opp=40, n_matches=100, n_msckf=8,
                              n_short=6, n_new_slam=10)
    cfg = pipe_mod.VioConfig(
        dims=dims, tracks=tracks, sigma_img=sigma_img_px / cam.fx, min_track_length=5,
        msckf_baseline_x_n=0.01, msckf_baseline_y_n=0.01, enable_range=False, enable_sun=False,
    )
    params = vio_mod.VioParams(cfg=cfg, dtype="float32", max_update_lag=32)
    v = vio_mod.VIO(params, device=device)
    v.init_at_time(float(ds.imu_t[0]), v=v0)

    imu_i = 1
    n_applied = 0
    errs = []
    n_frames = len(ds.frame_t) if max_frames is None else min(len(ds.frame_t), max_frames)
    for fr in range(n_frames):
        t_cam = float(ds.frame_t[fr])
        hi = int(np.searchsorted(ds.imu_t, t_cam + 1e-9))
        if hi > imu_i:
            v.process_imu_batch(ds.imu_t[imu_i:hi], np.arange(imu_i, hi), ds.imu_w[imu_i:hi],
                                ds.imu_a[imu_i:hi])
            imu_i = hi
        matches = ref_ingest.to_device_matches(ds.frames[fr], tracks.n_matches,
                                               dtype=torch.float32, device=device)
        n_applied += int(v.process_matches_measurement(t_cam, fr, matches))
        if ds.gt_p is not None:
            p = v.tail_state().p[0].cpu().numpy()
            errs.append(float(np.linalg.norm(p - ds.gt_p[fr])))
    out = dict(
        dataset_dir=root, frames=n_frames, applied=n_applied,
        ate=round(float(np.sqrt(np.mean(np.square(errs)))), 4) if errs else None,
        final_err=round(errs[-1], 4) if errs else None,
    )
    print(json.dumps(out))
    return out


def run_solo(meta, agent_idx: int, degraded: bool, force: bool = False, device=None,
             seed: int = 0):
    """One agent's solo replay, cached on disk keyed on its configuration,
    dataset and draws' ``seed`` (:func:`solo_cache_key`)."""
    key = solo_cache_key(meta, degraded, agent_idx, seed)
    cache = os.path.join(DATASET_ROOT, f"solo_a{agent_idx}_{key}.json")
    if os.path.exists(cache) and not force:
        with open(cache) as f:
            r = json.load(f)
        print(f"=== solo agent {agent_idx}: cached ({os.path.basename(cache)})", flush=True)
        return r
    print(f"=== solo pass: agent {agent_idx} (degraded={degraded}) ===", flush=True)
    v = build_agent(meta, degraded, None, None, agent_idx, collab=False, device=device, seed=seed)
    ckpt = cache + ".ckpt.npz"
    r = replay([v], [meta], exchange=False,
               trace_path=os.path.join(DATASET_ROOT, f"trace_solo_a{agent_idx}.npz"),
               ckpt_path=ckpt)
    with open(cache, "w") as f:
        json.dump(r, f)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    return r


def parse_args(argv=None):
    """The reference's flags."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--degraded", type=int, default=1, help="degraded agent index")
    ap.add_argument("--out", type=str, default="ATE_REPORT_torch.json")
    ap.add_argument("--vocab", choices=["thermal", "random"], default="thermal")
    ap.add_argument("--solo-only", action="store_true", help="run/refresh the solo passes and exit")
    ap.add_argument("--skip-solo", action="store_true",
                    help="collab pass only (use existing solo caches)")
    ap.add_argument("--force-solo", action="store_true")
    # exchange-path ablations; the receiver's CI weight is a local choice:
    # the degraded agent fuses strongly, helpers default to the same weight
    ap.add_argument("--ci-slam-w", type=float, default=-0.02)
    ap.add_argument("--ci-slam-w-helper", type=float, default=None,
                    help="helpers' ci_slam_w (default: same as --ci-slam-w)")
    ap.add_argument("--match-budget", type=int, default=6)
    ap.add_argument("--exchange-every", type=int, default=10)
    ap.add_argument("--cooldown", type=int, default=10)
    ap.add_argument("--no-rr", action="store_true",
                    help="disable the request-response exchange entirely")
    ap.add_argument("--no-store", action="store_true",
                    help="disable OPP match recording (rr SLAM-SLAM only)")
    ap.add_argument("--no-stored-slam", action="store_true")
    ap.add_argument("--no-stored-msckf", action="store_true")
    ap.add_argument("--no-shortci", action="store_true")
    ap.add_argument("--dataset-dir", type=str, default=None,
                    help="replay a reference-layout dataset directory (imu.csv + 10-double "
                         "matches.csv [+ gt.csv]) instead of the synthetic harness")
    ap.add_argument("--max-frames", type=int, default=None)
    return ap.parse_args(argv)


# the reference's shipped DBoW3 thermal vocabulary, expected in the repository
THERMAL_VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "Vocabulary", "thermal_voc_3_4_dbow3_calib.yaml")


def make_words(vocab: str, device=None) -> torch.Tensor:
    """The vocabulary (W, 32) uint8 on ``device``: the reference's shipped
    DBoW3 thermal vocabulary, or 32 words trained (k-majority, 7 iterations)
    on 512 seeded random descriptors."""
    from ..place_recognition.vocabulary import load_dbow3, train_kmajority

    if vocab == "thermal":
        if not os.path.exists(THERMAL_VOCAB):
            raise FileNotFoundError(f"the thermal DBoW3 vocabulary {THERMAL_VOCAB} is not in the "
                                    "repository; use the random vocabulary (--vocab random)")
        words = load_dbow3(THERMAL_VOCAB).words
    else:
        rng = np.random.default_rng(0)
        words = train_kmajority(rng.integers(0, 256, (512, 32)).astype(np.uint8), 32, 7).words
    return torch.as_tensor(np.asarray(words), dtype=torch.uint8, device=resolve(device))


def collab_config(args):
    """The degraded agent's ``CollabConfig`` from the flags; helpers take
    ``ci_slam_w = args.ci_slam_w_helper`` (:func:`helper_config`)."""
    from ..parallel import collab as collab_mod

    return collab_mod.CollabConfig(
        sigma_landmark=0.1, ci_slam_w=args.ci_slam_w, match_budget=args.match_budget,
        desc_ratio_thr=0.7, desc_abs_thr=35.0, pr_score_thr=0.15, pr_ransac_thr=0.005,
        geom_consistency_tol=0.3,
        # no SLAM landmark re-fuses against the same peer within
        # `refuse_cooldown` receives; a negative ci_slam_w fuses only from
        # more confident peers
        refuse_cooldown=args.cooldown, use_stored_slam=not args.no_stored_slam,
        use_stored_msckf=not args.no_stored_msckf, use_stored_shortci=not args.no_shortci,
        record_opp_matches=not args.no_store,
    )


def helper_config(args, ccfg):
    w_helper = args.ci_slam_w_helper if args.ci_slam_w_helper is not None else args.ci_slam_w
    return ccfg._replace(ci_slam_w=w_helper)


def run_report(args, device=None, seed: int = 0):
    """The report: every agent solo (cached), then all collaboratively,
    then the gates, every facade's draws keyed on ``seed``. Returns (report
    dict, the collaborative agents); ``None`` for the report with
    ``--solo-only``."""
    device = resolve(device)
    metas = ensure_dataset(args.agents, args.duration, args.height, args.width,
                           degraded_idx=args.degraded, device=device)
    words = make_words(args.vocab, device)
    ccfg = collab_config(args)
    hcfg = helper_config(args, ccfg)

    # pass 1: every agent solo (helper health is part of the report)
    solos = [run_solo(metas[a], a, a == args.degraded, force=args.force_solo, device=device,
                      seed=seed)
             for a in range(args.agents)]
    if args.solo_only:
        print(json.dumps(dict(solo_ate_aligned=[s["ate_aligned"][0] for s in solos],
                              solo_mean_nees=[s["mean_nees"][0] for s in solos]), indent=2))
        return None, []

    # pass 2: all agents, collaborative with REQUEST_COMM exchange
    print("=== collaborative pass ===", flush=True)
    agents = [build_agent(metas[a], a == args.degraded, words,
                          ccfg if a == args.degraded else hcfg, a, collab=True, device=device,
                          seed=seed)
              for a in range(args.agents)]
    # keyed like the solo caches: a checkpoint of other flags or data never resumes
    key = dict(salt=CODE_SALT, gen_keys=[m["gen_key"] for m in metas], seed=seed,
               args={k: v for k, v in vars(args).items() if k not in ("out", "force_solo")})
    digest = hashlib.sha1(json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]
    collab_ckpt = os.path.join(DATASET_ROOT, f"collab_{digest}.ckpt.npz")
    col = replay(agents, metas, exchange=not args.no_rr, exchange_every=args.exchange_every,
                 trace_path=os.path.join(DATASET_ROOT, "trace_collab.npz"), ckpt_path=collab_ckpt)
    if os.path.exists(collab_ckpt):
        os.remove(collab_ckpt)
    return report(args, solos, col, agents, ccfg, hcfg), agents


def report(args, solos, col, agents, ccfg, hcfg) -> dict:
    """The report's JSON from the solo and collaborative outputs."""
    di = args.degraded
    ate_solo = solos[di]["ate_aligned"][0]
    ate_collab = col["ate_aligned"][di]
    gain = 1.0 - ate_collab / ate_solo
    reduction = 1.0 - col["bytes_rr"] / col["bytes_full"] if col["bytes_full"] else 0.0
    # chi2(3) band for the MEAN of ~duration*10 temporally correlated NEES
    # samples (effective sample count conservatively ~N/10)
    lo, hi = NEES_BAND
    gates = dict(
        all_agents_nees_consistent=all(lo <= x <= hi for x in col["mean_nees"]),
        # CI fusion is conservative by construction, so the dangerous side
        # under collaboration is only the upper one
        no_agent_overconfident=all(x <= hi for x in col["mean_nees"]),
        helpers_converged_collab=all(col["ate_aligned"][a] < 1.0
                                     for a in range(args.agents) if a != di),
        degraded_gain_target=bool(gain >= 0.46),
    )
    return dict(
        dataset=dict(
            agents=args.agents, duration_s=args.duration, resolution=[args.height, args.width],
            frames=int(args.duration * 10), motion="orbit_6dof (yaw/pitch/roll + z-bob)",
            scene="front wall + side wall (non-planar)",
            thermal="gain drift + corner vignette + noise (baked)", vocabulary=args.vocab,
        ),
        ablation=dict(
            rr=not args.no_rr, store=not args.no_store, stored_slam=ccfg.use_stored_slam,
            stored_msckf=ccfg.use_stored_msckf, stored_shortci=ccfg.use_stored_shortci,
            ci_slam_w_degraded=args.ci_slam_w, ci_slam_w_helper=hcfg.ci_slam_w,
            exchange_every=args.exchange_every, refuse_cooldown=args.cooldown,
        ),
        degraded_agent=dict(
            index=di, ate_solo_m=round(ate_solo, 4), ate_collab_m=round(ate_collab, 4),
            ate_solo_raw_m=round(solos[di]["ate"][0], 4), ate_collab_raw_m=round(col["ate"][di], 4),
            collab_gain_pct=round(100 * gain, 1),
            mean_nees_solo=round(solos[di]["mean_nees"][0], 2),
            mean_nees_collab=round(col["mean_nees"][di], 2),
        ),
        per_agent=dict(
            ate_solo_m=[round(s["ate_aligned"][0], 4) for s in solos],
            mean_nees_solo=[round(s["mean_nees"][0], 2) for s in solos],
            ate_collab_m=[round(a, 4) for a in col["ate_aligned"]],
            ate_collab_raw_m=[round(a, 4) for a in col["ate"]],
            mean_nees_collab=[round(x, 2) for x in col["mean_nees"]],
            max_nees_collab=[round(x, 1) for x in col["max_nees"]],
            rr_fused=col["rr_fused"], n_reinits=col["n_reinits"],
        ),
        request_comm=dict(
            hits=col["n_hits"], bytes_request_response=col["bytes_rr"],
            bytes_full_broadcast=col["bytes_full"],
            bandwidth_reduction_pct=round(100 * reduction, 1),
        ),
        keyframes_selected=[int(v.n_keyframes_selected) for v in agents],
        gates=gates,
    )


def main(argv=None) -> int:
    """The CLI: returns 2 when a gate fails, as the reference exits."""
    import sys

    args = parse_args(argv)
    if args.dataset_dir:
        replay_dataset_dir(args.dataset_dir, max_frames=args.max_frames)
        return 0
    rep, _ = run_report(args)
    if rep is None:
        return 0
    print(json.dumps(rep, indent=2))
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=2)
    print(f"wrote {args.out}")
    if not all(rep["gates"].values()):
        print(f"GATES FAILED: {rep['gates']}", file=sys.stderr)
        return 2
    return 0
