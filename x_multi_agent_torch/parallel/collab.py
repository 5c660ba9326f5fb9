"""Collaborative full-map exchange round (port of the SLAM-SLAM part of
``x_multi_agent_tpu.parallel.collab``).

Every agent snapshots a payload (camera window, SLAM landmarks and their
joint covariance); every agent then fuses every peer's payload in turn:
ground-truth-style landmark matching, one joint CI update at its newest
buffer state, tail repropagation. Agents are the leading axis; peers are a
Python loop in which all agents fuse peer ``b`` at once. The round reads
nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ekf import buffer as rb
from ..ekf import ekf as ekf_mod
from ..ops import linalg
from ..place_recognition.gt_matching import match_landmarks
from ..utils import tree
from ..vio.updates import multi_slam
from ..vio.vio import VioParams
from .payload import AgentPayload, make_payload, slam_landmarks_world


class CollabConfig(NamedTuple):
    """The fields of the reference's ``CollabConfig`` that the full-map
    round reads, with its defaults (the descriptor and match-store fields
    belong to paths that are not ported)."""

    sigma_landmark: float = 0.1
    ci_slam_w: float = 0.01  # weight given to the peer; < 0: downhill-only, |w|
    gt_match_dist: float = 0.5  # proximity gate [m]
    match_budget: int = 10  # SLAM-SLAM matches per peer


def _buffer_time(fs, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(rb.times(fs.buffer), 1, idx.long()[:, None])[:, 0]


def extract_payload(params: VioParams, fs) -> AgentPayload:
    """Snapshot every agent's anchor-state vision and covariance."""
    return make_payload(params.cfg.dims, _buffer_time(fs, fs.anchor_buf_idx), fs.vision, fs.cov)


def fuse_with_peer(params: VioParams, ccfg: CollabConfig, fs, peer: AgentPayload,
                   peer_valid: torch.Tensor):
    """Every agent fuses its own peer snapshot (``peer`` fields (A, ...),
    ``peer_valid`` (A,)): match landmarks, CI-fuse at the agent's newest
    buffer state (the landmark residual does not depend on the snapshot's
    age), repropagate. Returns (fs, n_applied (A,))."""
    dims = params.cfg.dims

    def update_fn(core, vision, cov, aux):
        own_lm, own_valid = slam_landmarks_world(dims, vision)
        own_idx, other_idx, mvalid = match_landmarks(
            own_lm, own_valid, peer.landmarks, peer.landmark_valid,
            ccfg.gt_match_dist, ccfg.match_budget,
        )
        core, vision, cov, n_app, _ = multi_slam.apply_matches(
            dims, core, vision, cov,
            peer.p_arr, peer.q_arr, peer.f_arr, peer.anchor_idx, peer.lm_cov,
            own_idx, other_idx, mvalid & peer_valid[:, None],
            ccfg.sigma_landmark, ccfg.ci_slam_w,
        )
        return core, vision, cov, aux + n_app

    n0 = torch.zeros_like(fs.head)
    fs, n_applied, _ = ekf_mod.process_update_aux_impl(
        params.ekf_params, fs, _buffer_time(fs, fs.head), update_fn, n0
    )
    return fs, n_applied


def collaborative_round(params: VioParams, ccfg: CollabConfig, fs):
    """One full-map exchange round for A agents. Every agent fuses every
    peer's payload in peer order (its own, masked, included, as the
    reference does). Returns (fs, n_matches (A, A)): entry [a, b] counts the
    matches agent a fused from agent b.

    On CUDA tensors raises if TF32 matmuls are on."""
    linalg.require_fp32_matmul(fs.cov.device, "collaborative_round")
    payloads = extract_payload(params, fs)
    a = fs.cov.shape[0]
    ids = torch.arange(a, device=fs.cov.device)
    ns = []
    for b in range(a):
        peer = tree.map_leaves(lambda x: x[b].expand((a,) + x.shape[1:]), payloads)
        fs, n = fuse_with_peer(params, ccfg, fs, peer, ids != b)
        ns.append(n)
    return fs, torch.stack(ns, dim=1)


def payload_nbytes(payload: AgentPayload) -> int:
    """Wire size in bytes of one agent's payload (static)."""
    leaves = (getattr(payload, f.name) for f in dataclasses.fields(payload))
    return sum(x[0].numel() * x.element_size() for x in leaves)
