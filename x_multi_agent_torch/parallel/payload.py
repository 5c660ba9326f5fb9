"""Inter-agent exchange payloads (port of ``x_multi_agent_tpu.parallel.payload``).

One agent's broadcastable snapshot: camera window, inverse-depth features,
the window-pose covariance block and the joint world-frame landmark
covariance blocks (the compact wire form: every SLAM-SLAM update the
receiver runs needs only these projections of the sender's covariance).
Every field carries the leading agent axis A.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ekf.state import StateDims, VisionState
from ..utils.tree import take
from ..vio.updates.multi_slam import _landmark_jac_blocks, landmark_world


@dataclass(frozen=True)
class AgentPayload:
    """The reference's ``AgentPayload``, (A, ...) per field. The descriptor
    and collaborative-track fields are zero-filled here (no descriptors in
    the full-map round)."""

    time: torch.Tensor  # (A,) snapshot time
    p_arr: torch.Tensor  # (A, M, 3) camera positions (world)
    q_arr: torch.Tensor  # (A, M, 4) camera attitudes
    f_arr: torch.Tensor  # (A, N, 3) inverse-depth features
    anchor_idx: torch.Tensor  # (A, N) int32
    pose_cov: torch.Tensor  # (A, 6M, 6M) window-pose covariance block
    lm_cov: torch.Tensor  # (A, N, N, 3, 3) joint landmark covariance blocks
    n_valid_poses: torch.Tensor  # (A,) int32
    n_valid_features: torch.Tensor  # (A,) int32
    landmarks: torch.Tensor  # (A, N, 3) SLAM features in world coordinates
    landmark_valid: torch.Tensor  # (A, N) bool
    slam_desc: torch.Tensor  # (A, N, 32) uint8
    slam_desc_valid: torch.Tensor  # (A, N) bool
    slam_obs: torch.Tensor  # (A, N, 2)
    trk_obs: torch.Tensor  # (A, Kt, M, 2)
    trk_mask: torch.Tensor  # (A, Kt, M) bool
    trk_desc: torch.Tensor  # (A, Kt, 32) uint8
    trk_desc_valid: torch.Tensor  # (A, Kt) bool
    trk_id: torch.Tensor  # (A, Kt) int32, -1 invalid
    slam_id: torch.Tensor  # (A, N) int32, -1 invalid


def slam_landmarks_world(dims: StateDims, vision: VisionState):
    """World positions (A, N, 3) of the SLAM features and their validity
    (A, N): inside the live count and anchored."""
    a_safe = torch.clamp(vision.anchor_idx, min=0)
    lms = landmark_world(vision.f_arr, take(vision.q_arr, a_safe), take(vision.p_arr, a_safe))
    return lms, vision.feature_mask(dims) & (vision.anchor_idx >= 0)


def landmark_covariances(dims: StateDims, vision: VisionState, cov: torch.Tensor) -> torch.Tensor:
    """(A, N, N, 3, 3) joint world-frame covariance of the SLAM landmarks,
    Lambda_ij = H_i P H_j^T, H_j = d(G_p_f)/d(anchor pos, anchor att, ivd):
    the nine 3x3 block products per pair, cross-landmark terms included."""
    m, n = dims.n_poses, dims.n_features
    a = cov.shape[0]
    a_safe = torch.clamp(vision.anchor_idx, min=0)
    jacs = torch.stack(_landmark_jac_blocks(vision.f_arr, take(vision.q_arr, a_safe)), dim=2)
    feat = torch.arange(n, device=cov.device).expand(a, n)
    cols = torch.stack([15 + 3 * a_safe, 15 + 3 * m + 3 * a_safe, 15 + 6 * m + 3 * feat], -1)
    idx = (cols.long()[..., None] + torch.arange(3, device=cov.device)).reshape(a, 9 * n)
    # P restricted to the landmarks' columns: (A, N, 3 blocks, 3, N, 3 blocks, 3)
    p_sub = take(take(cov, idx).transpose(1, 2), idx).transpose(1, 2)
    p_sub = p_sub.reshape(a, n, 3, 3, n, 3, 3)
    # jacs[a, i, block, out, in]
    return torch.einsum("aibox,aibxjcy,ajcsy->aijos", jacs, p_sub, jacs)


def make_payload(dims: StateDims, time: torch.Tensor, vision: VisionState, cov: torch.Tensor,
                 n_collab_tracks: int = 8) -> AgentPayload:
    """Snapshot of A agents at ``time`` (A,), the descriptor and track
    fields zero-filled."""
    lms, valid = slam_landmarks_world(dims, vision)
    m, n = dims.n_poses, dims.n_features
    a = cov.shape[0]
    dtype, dev = cov.dtype, cov.device
    kt = n_collab_tracks

    def zeros(*shape, dt=dtype):
        return torch.zeros((a,) + shape, dtype=dt, device=dev)

    return AgentPayload(
        time=time.to(dtype),
        p_arr=vision.p_arr,
        q_arr=vision.q_arr,
        f_arr=vision.f_arr,
        anchor_idx=vision.anchor_idx,
        pose_cov=cov[:, 15 : 15 + 6 * m, 15 : 15 + 6 * m],
        lm_cov=landmark_covariances(dims, vision, cov),
        n_valid_poses=vision.n_valid_poses,
        n_valid_features=vision.n_valid_features,
        landmarks=lms,
        landmark_valid=valid,
        slam_desc=zeros(n, 32, dt=torch.uint8),
        slam_desc_valid=zeros(n, dt=torch.bool),
        slam_obs=zeros(n, 2),
        trk_obs=zeros(kt, m, 2),
        trk_mask=zeros(kt, m, dt=torch.bool),
        trk_desc=zeros(kt, 32, dt=torch.uint8),
        trk_desc_valid=zeros(kt, dt=torch.bool),
        trk_id=torch.full((a, kt), -1, dtype=torch.int32, device=dev),
        slam_id=torch.full((a, n), -1, dtype=torch.int32, device=dev),
    )
