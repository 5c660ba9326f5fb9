"""Stage-by-stage bisect of the request-response SLAM-SLAM fusion gates
(port of the reference's ``scripts/debug_collab_gates.py``).

Drives two agents (0 and 2 of the ATE report's 3-agent dataset, agent 1
degraded) through the image replay for ``--frames`` frames, then runs one
receive (the peer's payload -> ``collab.fuse_with_peer_desc``) under every
gate combination and prints how many matches survive each stage:

  kNN(ratio+abs) -> epipolar RANSAC -> pairwise-distance consistency ->
  refuse-cooldown -> chi2(3) + downhill trace gate (n_applied)

then the REQUEST_COMM receive through the keyframe B serves A. With
``KF_PROBE`` set in the environment it also probes the served keyframe's
content. ``--vocab thermal`` needs the reference's DBoW3 thermal vocabulary
in the repository; ``random`` (the default) trains 32 words on seeded
random descriptors (``ate_report.make_words``).

Entry points run on the card unless ``device`` says otherwise; the CLI is
``scripts/debug_collab_gates_torch.py``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import ate_report as ar

AGENTS = (0, 2)  # A and B; agent 1 of the dataset is the degraded one


def collab_config():
    """The bisect's ``CollabConfig`` (the ATE report's degraded agent's)."""
    from ..parallel import collab as collab_mod

    return collab_mod.CollabConfig(
        sigma_landmark=0.1, ci_slam_w=-0.02, match_budget=6, desc_ratio_thr=0.7,
        desc_abs_thr=35.0, pr_score_thr=0.15, pr_ransac_thr=0.005, geom_consistency_tol=0.3,
        refuse_cooldown=10,
    )


# each gate switched off alone, all of them, and the two-sided CI weight
VARIANTS = dict(
    full=dict(),
    no_ransac=dict(pr_ransac_thr=0.0),
    no_geom=dict(geom_consistency_tol=0.0),
    no_cooldown=dict(refuse_cooldown=0),
    no_gates=dict(pr_ransac_thr=0.0, geom_consistency_tol=0.0, refuse_cooldown=0),
    no_gates_posw=dict(pr_ransac_thr=0.0, geom_consistency_tol=0.0, refuse_cooldown=0,
                       ci_slam_w=0.02),
    posw_only=dict(ci_slam_w=0.02),
)


def parse_args(argv=None):
    """The reference's flag, and the vocabulary."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--vocab", choices=["random", "thermal"], default="random")
    ap.add_argument("--cpu-check", action="store_true",
                    help="also bisect CPU float64 copies of the same two agents")
    return ap.parse_args(argv)


def replay_pair(metas, words, ccfg, frames: int, device=None):
    """Agents A and B built as the ATE report builds collaborating agents,
    fed their first ``frames`` frames interleaved (the report's fixed-stride
    IMU windows), with no exchange. Returns (A, B)."""
    from . import dataio

    agents = [ar.build_agent(metas[a], a == 1, words, ccfg, a, collab=True, device=device)
              for a in AGENTS]
    data = [dataio.load_euroc_style(metas[a]["dir"], time_scale=1.0) for a in AGENTS]
    imgs = [dataio.load_pgm_batch(d.cam_paths[:frames]) for d in data]
    n_per = int(round((len(data[0].imu_t) - 1) / len(data[0].cam_t)))
    for f in range(frames):
        for v, d, im in zip(agents, data, imgs):
            i = f * n_per + 1
            j = min(i + n_per, len(d.imu_t))
            v.process_imu_batch(d.imu_t[i:j], np.arange(i, j), d.imu_w[i:j], d.imu_a[i:j])
            v.process_image_measurement(float(d.cam_t[f]), f, im[f])
        if f % 20 == 19:
            print(f"frame {f+1}", flush=True)
    return agents


def clone_agent(v, meta, uav_id: int, device, dtype: str = "float64"):
    """Facade ``v`` (built by :func:`replay_pair`) again on ``device`` in
    ``dtype``, holding ``v``'s whole replay state
    (``ate_report._agent_state``, float leaves cast): the same states for a
    bisect elsewhere."""
    from .tree import map_leaves

    c = ar.build_agent(meta, uav_id == 1, v._words.to(device), v._ccfg, uav_id, collab=True,
                       device=device, dtype=dtype)
    tdt = getattr(torch, dtype)
    state = map_leaves(lambda x: x.to(device, tdt) if x.is_floating_point() else x.to(device),
                       ar._agent_state(v, max(AGENTS) + 1))
    ar._restore_agent(c, state)
    return c


def _cov_health(cov: torch.Tensor) -> dict:
    """Finiteness, largest asymmetry and smallest position-block
    eigenvalue of one (1, D, D) covariance (one host read)."""
    c = cov[0].to(torch.float64)
    r = torch.stack([torch.isfinite(c).all().to(torch.float64), (c - c.T).abs().max(),
                     c.abs().max(), torch.linalg.eigvalsh((c[:3, :3] + c[:3, :3].T) / 2)[0]])
    finite, asym, scale, eig = r.cpu().tolist()
    return dict(finite=bool(finite), max_asym=asym, max_abs=scale, min_pos_eig=eig)


def _variants(va, ccfg, fs, slots, payload, sampler):
    """``fuse_with_peer_desc`` of ``payload`` on the same (fs, slots) under
    every variant: (n_applied per variant, covariance health per variant)."""
    from ..parallel import collab as collab_mod

    valid = torch.ones(1, dtype=torch.bool, device=va.device)
    counts, health = {}, {}
    for name, over in VARIANTS.items():
        fs_v, n, _ = collab_mod.fuse_with_peer_desc(va.params, ccfg._replace(**over), fs, slots,
                                                    payload, valid, recency=None, sampler=sampler)
        counts[name] = int(n[0])
        health[name] = _cov_health(fs_v.cov)
    return counts, health


def bisect(va, vb, ccfg, kf_probe: bool = False) -> dict:
    """The bisect on A's state against B: the kNN count, each variant's
    matches applied, and the receive of B's served keyframe; with
    ``kf_probe`` the keyframe's content. Prints the reference's lines and
    returns the counts (``"cov"``: each variant's covariance health)."""
    from ..ekf import buffer as rb
    from ..ops.ransac import fundamental_ransac, keyed_sample_indices
    from ..place_recognition.descriptors import knn2_match

    payload = vb.get_data_to_send()
    slots, fs = va.slots, va.fs
    _, ok = knn2_match(slots.slam_desc, slots.slam_desc_valid, payload.slam_desc,
                       payload.slam_desc_valid, ccfg.desc_ratio_thr, ccfg.desc_abs_thr)
    out = dict(own_valid=int(slots.slam_desc_valid.sum()),
               peer_valid=int(payload.slam_desc_valid.sum()), n_knn=int(ok.sum()))
    print("own slam slots valid:", out["own_valid"], "| peer:", out["peer_valid"])
    print("stage kNN(ratio+abs):", out["n_knn"])
    out["variants"], out["cov"] = _variants(va, ccfg, fs, slots, payload, va.sampler)
    for name, n in out["variants"].items():
        print(f"variant {name:14s}: n_applied = {n}")

    # the replay's own path: the keyframe B serves A through REQUEST_COMM
    kf, found = vb.process_other_requests(0, va.get_descriptors())
    out.update(keyframes_b=int(vb.n_keyframes_selected), hit=bool(found), rr_fused=None)
    print("keyframes in B:", out["keyframes_b"], "| hit:", found)
    if found:
        out["rr_fused"] = va.process_other_measurements(kf, uav_id=AGENTS[1])
        print("rr fused via served keyframe:", out["rr_fused"])

    if found and kf_probe:
        from .tree import take

        oi2, ok2 = knn2_match(slots.slam_desc, slots.slam_desc_valid, kf.slam_desc,
                              kf.slam_desc_valid, ccfg.desc_ratio_thr, ccfg.desc_abs_thr)
        m = va.params.cfg.dims.n_poses
        own_pts = slots.slam_obs[:, :, m - 1]
        peer_pts = take(kf.slam_obs, oi2)
        # a fixed key (seed 0, key 0) where the reference draws from PRNGKey(0)
        idx = keyed_sample_indices(ok2, 200, 8, 0, 0)
        inl, _ = fundamental_ransac(own_pts, peer_pts, ok2, idx, ccfg.pr_ransac_thr)
        probe = dict(kf_desc_valid=int(kf.slam_desc_valid.sum()), kf_knn=int(ok2.sum()),
                     kf_landmark_valid=int(kf.landmark_valid.sum()), kf_time=float(kf.time[0]),
                     fs_tail_time=float(rb.times(fs.buffer)[0, fs.head[0]]),
                     after_ransac=int((inl & ok2).sum()))
        print("kf slam_desc_valid:", probe["kf_desc_valid"], "kNN ok:", probe["kf_knn"])
        print("kf landmark_valid:", probe["kf_landmark_valid"])
        print("kf time:", probe["kf_time"], "fs tail:", probe["fs_tail_time"])
        print("after ransac:", probe["after_ransac"])
        probe["variants"], _ = _variants(va, ccfg, fs, slots, kf, va.sampler)
        for name, n in probe["variants"].items():
            print(f"KF variant {name:14s}: n_applied = {n}")
        out["kf_probe"] = probe
    return out


def run(frames: int = 120, vocab: str = "random", duration: float = 60.0, h: int = 480,
        w: int = 640, device=None, kf_probe=None, cpu_check: bool = False) -> dict:
    """The bisect after ``frames`` frames of the ``duration``-s dataset
    (``ate_report.ensure_dataset`` of 3 agents at ``h`` x ``w``, agent 1
    degraded); ``kf_probe`` defaults to the ``KF_PROBE`` environment
    variable. Returns :func:`bisect`'s counts; with ``cpu_check`` also the
    bisect of CPU float64 copies of the same two agents (``"cpu"``) and
    whether every count of the two agrees (``"cpu_agrees"``)."""
    from ..device import resolve

    device = resolve(device)
    words = ar.make_words(vocab, device)  # raises first when the thermal file is missing
    metas = ar.ensure_dataset(3, duration, h, w, degraded_idx=1, device=device)
    ccfg = collab_config()
    va, vb = replay_pair(metas, words, ccfg, frames, device)
    if kf_probe is None:
        kf_probe = bool(os.environ.get("KF_PROBE"))
    copies = [clone_agent(v, metas[a], a, "cpu") for v, a in zip((va, vb), AGENTS)] \
        if cpu_check else None
    out = bisect(va, vb, ccfg, kf_probe)
    if copies:
        print("--- the same states on the CPU in float64 ---")
        out["cpu"] = bisect(*copies, ccfg, kf_probe)
        counts = ("own_valid", "peer_valid", "n_knn", "variants", "keyframes_b", "hit", "rr_fused")
        out["cpu_agrees"] = all(out[k] == out["cpu"][k] for k in counts)
        print("card and CPU float64 counts agree:", out["cpu_agrees"])
    return out


def main(argv=None, device=None) -> dict:
    args = parse_args(argv)
    return run(args.frames, args.vocab, device=device, cpu_check=args.cpu_check)
