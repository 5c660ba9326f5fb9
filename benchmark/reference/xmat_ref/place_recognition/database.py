"""Keyframe database and the VLAD request-response policy (port of
``x_multi_agent_tpu.place_recognition.database``).

Per agent: a ring of keyframes, each a payload snapshot with its VLAD and
the set of peers it has already served (each keyframe answers each peer at
most once). A requester broadcasts only its VLAD; a responder ships the
heavy payload only on a hit (score above ``pr_score_thr``).

Every field carries the leading agent axis A. The served set is a bitmap of
``DbDims.max_agents`` columns indexed by the requester's id: an id outside
it raises (the reference clamps the read and drops the write there).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from ..parallel.payload import AgentPayload
from ..utils import tree
from .vlad import compute_vlad, vlad_score


class DbDims(NamedTuple):
    n_keyframes: int = 15  # ring size
    n_words: int = 64  # vocabulary leaves
    max_agents: int = 8  # served-peer bitmap width


@dataclass(frozen=True)
class KeyframeDB:
    payload: AgentPayload  # (A, R, ...)
    vlad: torch.Tensor  # (A, R, W, 32) uint8
    served: torch.Tensor  # (A, R, max_agents) bool
    valid: torch.Tensor  # (A, R)
    wptr: torch.Tensor  # (A,) int32 ring write pointer

    @staticmethod
    def zero(db_dims: DbDims, payload_proto: AgentPayload) -> "KeyframeDB":
        """An empty ring per agent, payload slots shaped like ``payload_proto``
        (A, ...)."""
        r = db_dims.n_keyframes
        a = payload_proto.time.shape[0]
        dev = payload_proto.time.device

        def ring(x):
            return torch.zeros((a, r) + x.shape[1:], dtype=x.dtype, device=dev)

        return KeyframeDB(
            payload=tree.map_leaves(ring, payload_proto),
            vlad=torch.zeros((a, r, db_dims.n_words, 32), dtype=torch.uint8, device=dev),
            served=torch.zeros((a, r, db_dims.max_agents), dtype=torch.bool, device=dev),
            valid=torch.zeros((a, r), dtype=torch.bool, device=dev),
            wptr=torch.zeros((a,), dtype=torch.int32, device=dev),
        )


def _check_id(db: KeyframeDB, uav_id: int) -> None:
    width = db.served.shape[-1]
    if not 0 <= uav_id < width:
        raise ValueError(f"agent id {uav_id} outside the served bitmap of {width} agents "
                         "(raise DbDims.max_agents)")


def add_keyframe(db_dims: DbDims, db: KeyframeDB, payload: AgentPayload,
                 words: torch.Tensor) -> KeyframeDB:
    """Insert every agent's keyframe at its write pointer (FIFO ring): the
    payload, its VLAD over the SLAM-track descriptors, a cleared served set."""
    i = db.wptr.long()[:, None]
    vlad = compute_vlad(words, payload.slam_desc, payload.slam_desc_valid)
    a = db.valid.shape[0]
    dev = db.valid.device
    return KeyframeDB(
        payload=dataclasses.replace(payload, **{
            f.name: tree.put(getattr(db.payload, f.name), i, getattr(payload, f.name)[:, None])
            for f in dataclasses.fields(payload)
        }),
        vlad=tree.put(db.vlad, i, vlad[:, None]),
        served=tree.put(db.served, i, torch.zeros((a, 1, db_dims.max_agents), dtype=torch.bool,
                                                  device=dev)),
        valid=tree.put(db.valid, i, torch.ones((a, 1), dtype=torch.bool, device=dev)),
        wptr=((db.wptr + 1) % db_dims.n_keyframes).to(torch.int32),
    )


def find_candidate(db: KeyframeDB, uav_id: int, query_vlad: torch.Tensor,
                   score_thr: float) -> Tuple[torch.Tensor, torch.Tensor, KeyframeDB]:
    """Best-scoring keyframe not yet served to requester ``uav_id``, above
    the threshold, per agent; marks it served. Returns (keyframe index (A,),
    found (A,), new db)."""
    best, found, _, db = find_candidate_scored(db, uav_id, query_vlad, score_thr)
    return best, found, db


def find_candidate_scored(db: KeyframeDB, uav_id: int, query_vlad: torch.Tensor,
                          score_thr: float):
    """:func:`find_candidate` that also returns the winning VLAD score
    (float32). ``query_vlad`` (A, W, 32): each agent's database answers its
    own query row. The first index wins among equal scores. Returns (index
    (A,) int32, found (A,), score (A,), new db)."""
    _check_id(db, uav_id)
    scores = vlad_score(query_vlad[:, None], db.vlad)  # (A, R)
    eligible = db.valid & ~db.served[:, :, uav_id]
    scores = torch.where(eligible, scores, -1.0)
    best = torch.argmax(scores, dim=1)
    score = torch.gather(scores, 1, best[:, None])[:, 0]
    found = score > score_thr
    col = db.served[:, :, uav_id].clone()
    ar = torch.arange(col.shape[0], device=col.device)
    col[ar, best] = col[ar, best] | found
    served = db.served.clone()
    served[:, :, uav_id] = col
    return best.to(torch.int32), found, score, dataclasses.replace(db, served=served)


def get_keyframe(db: KeyframeDB, idx: torch.Tensor) -> AgentPayload:
    """Each agent's keyframe ``idx`` (A,) as an (A, ...) payload."""
    return tree.map_leaves(lambda x: tree.take(x, idx), db.payload)
