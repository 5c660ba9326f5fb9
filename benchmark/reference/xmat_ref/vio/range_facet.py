"""Facet selection for the LRF range update (port of
``x_multi_agent_tpu.vio.range_facet``).

With N <= 15 SLAM features, every one of the C(N, 3) triangles is tested for
containment of the LRF image point, and the containing triangle of least
area is the facet (the Delaunay facet wherever the triangulation covers the
point).
"""
from __future__ import annotations

import itertools
from typing import Tuple

import torch

from ..utils.const import constant


def feature_triangle_at_point(
    pts: torch.Tensor,  # (A, N, 2) SLAM feature image coordinates
    valid: torch.Tensor,  # (A, N)
    query: torch.Tensor,  # (A, 2)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (feature ids (A, 3) int32, found (A,) bool). With no
    containing triangle, ``argmin`` picks the first one in both packages."""
    n = pts.shape[1]
    tri = constant(tuple(itertools.combinations(range(n), 3)), torch.long, pts.device)  # (T, 3)
    a, b, c = pts[:, tri[:, 0]], pts[:, tri[:, 1]], pts[:, tri[:, 2]]  # (A, T, 2)

    def cross(o, u, v):
        return ((u[..., 0] - o[..., 0]) * (v[..., 1] - o[..., 1])
                - (u[..., 1] - o[..., 1]) * (v[..., 0] - o[..., 0]))

    q = query[:, None, :].expand_as(a)
    d0, d1, d2 = cross(a, b, q), cross(b, c, q), cross(c, a, q)
    inside = ((d0 >= 0) & (d1 >= 0) & (d2 >= 0)) | ((d0 <= 0) & (d1 <= 0) & (d2 <= 0))
    area = torch.abs(cross(a, b, c))
    ok = inside & (area > 1e-12) & valid[:, tri].all(-1)
    best = torch.argmin(torch.where(ok, area, float("inf")), dim=1)
    return tri[best].to(torch.int32), torch.gather(ok, 1, best[:, None])[:, 0]
