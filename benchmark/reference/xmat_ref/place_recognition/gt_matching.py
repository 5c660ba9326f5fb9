"""Ground-truth landmark matching (port of
``x_multi_agent_tpu.place_recognition.gt_matching``).

Cross-agent correspondences from 3D landmark proximity: pairwise distances
-> mutual nearest neighbours within a radius, emitted into a fixed budget
(kept matches first, in own-slot order).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.tree import take


def match_landmarks(
    own_lm: torch.Tensor,  # (A, N, 3)
    own_valid: torch.Tensor,  # (A, N)
    other_lm: torch.Tensor,  # (A, N, 3)
    other_valid: torch.Tensor,  # (A, N)
    max_dist: float,
    budget: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (own_idx (A, budget), other_idx (A, budget), valid (A, budget)).

    ``argmin`` returns the first minimum in both packages, so rows or columns
    with no valid pair point at index 0."""
    n = own_lm.shape[1]
    d2 = torch.sum((own_lm[:, :, None, :] - other_lm[:, None, :, :]) ** 2, dim=-1)
    d2 = torch.where(own_valid[:, :, None] & other_valid[:, None, :], d2, float("inf"))
    nn_other = torch.argmin(d2, dim=2)  # (A, N) for each own landmark
    nn_own = torch.argmin(d2, dim=1)  # (A, N) for each peer landmark
    own_ids = torch.arange(n, device=own_lm.device)
    mutual = take(nn_own, nn_other) == own_ids
    close = torch.gather(d2, 2, nn_other[..., None])[..., 0] < max_dist * max_dist
    good = mutual & close & own_valid
    order = torch.argsort((~good).to(torch.int8), dim=1, stable=True)[:, :budget]
    return (order.to(torch.int32), take(nn_other, order).to(torch.int32),
            take(good, order))
