"""Multi-agent exchange across ranks (port of
``x_multi_agent_tpu.parallel.mesh``).

The reference's distribution axis is N agents, each its own process,
exchanging payloads over a radio link (SURVEY §2.9.5, §5.8). Here one
``torch.distributed`` rank per process holds a contiguous block of agents
(rank r: agents ``r * blk .. r * blk + blk - 1``, as the TPU mesh shards its
agent axis); the per-agent filtering runs batched over the block, and the
exchange rounds are collectives:

  * the full-map round is one ``all_gather`` of the block's payloads, then
    every agent fuses every peer locally (:func:`sharded_collab_round`);
  * REQUEST_COMM is one ``all_gather`` of the query VLADs, the responders'
    scoring against their own keyframe rings, one ``all_to_all`` of the
    score-gated keyframes responder -> requester, and the requesters' top-K
    fusion (:func:`sharded_collab_round_desc`).

Each collective ships one flat ``uint8`` buffer (the leaves of its
containers packed byte for byte). With gloo the buffer is staged through
host memory, the radio link's analog; with NCCL it stays on the card, and
NCCL refuses two ranks on one device. As the reference jits its rounds,
both are compiled by default (:class:`ShardedRound`: with NCCL one CUDA
graph per call, its collectives inside; with gloo a graph per segment
between the host-staged collectives); ``compiled=False`` gives the plain
round, which runs the same segments op by op. The rounds equal the single-process
rounds of ``parallel.collab`` on the same agents: every row of every
computation depends on its own agent alone, and the RANSAC draws are keyed
on each agent's state (``ops.ransac.KeyedSampler``).
"""
from __future__ import annotations

import dataclasses
import io
import queue as queue_mod
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from ..device import resolve
from ..ekf import ekf as ekf_mod
from ..ops import linalg
from ..place_recognition import database as db_mod
from ..utils import graph, tree
from ..vio import pipeline
from ..vio import vio as vio_mod
from . import collab


@dataclasses.dataclass
class AgentMesh:
    """One rank of the agent mesh: its process group, rank, world size and
    device, and the bytes each named collective has shipped from this rank
    to the others (``shipped``)."""

    group: Any
    rank: int
    world_size: int
    device: torch.device
    backend: str
    shipped: Dict[str, int] = dataclasses.field(default_factory=dict)

    def block(self, n_agents: int) -> slice:
        """This rank's agents of ``n_agents``; raises unless the ranks
        split them evenly."""
        if n_agents % self.world_size:
            raise ValueError(f"{n_agents} agents do not split over {self.world_size} ranks")
        blk = n_agents // self.world_size
        return slice(self.rank * blk, (self.rank + 1) * blk)


def make_agent_mesh(backend: str, init_method: str, rank: int, world_size: int, device=None,
                    timeout_s: float = 120.0) -> AgentMesh:
    """Join the process group as ``rank`` of ``world_size`` (one rank per
    process). ``device=None`` is ``cuda:(rank % device_count)`` and raises
    without a card. A collective that waits longer than ``timeout_s``
    raises. NCCL needs a device of its own per rank: asking for it with
    more ranks than devices raises (use gloo). A CUDA device without an
    index is ``cuda:(rank % device_count)`` too."""
    device = resolve(device)  # None -> cuda, or raise without a card
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl":
        n_dev = torch.cuda.device_count()
        if device.type != "cuda" or world_size > n_dev:
            raise ValueError(f"nccl cannot put {world_size} ranks on {n_dev} CUDA device(s): "
                             "it refuses two ranks on one device; use backend='gloo'")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return AgentMesh(dist.group.WORLD, rank, world_size, device, backend)


# ---------------------------------------------------------------------------
# the wire: containers packed into one uint8 buffer
# ---------------------------------------------------------------------------


def _pack(obj) -> torch.Tensor:
    """Every tensor leaf of ``obj`` byte for byte, in leaf order."""
    parts = [x.contiguous().view(torch.uint8).reshape(-1)
             for x in tree.leaves(obj) if isinstance(x, torch.Tensor)]
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, template):
    """The inverse of :func:`_pack` into ``template``'s structure, shapes
    and dtypes (Python scalar leaves are the template's)."""
    out, off = [], 0
    for x in tree.leaves(template):
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        n = x.numel() * x.element_size()
        out.append(buf[off:off + n].clone().view(x.dtype).reshape(x.shape))
        off += n
    return tree.unflatten(template, out)


def _meta(obj):
    """``obj``'s structure, shapes and dtypes, its tensor leaves on the meta
    device: a template for :func:`_unpack` that holds no memory."""
    return tree.map_leaves(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), obj)


def _put(kind: str, obj, w: int):
    """A collective's flat send buffer and the template of one rank's piece
    of what arrives. ``all_gather`` ships the block ``obj`` (leaves (blk,
    ...)) to every rank; ``all_to_all`` ships columns ``q * blk .. q * blk +
    blk - 1`` of the grid ``obj`` (leaves (blk, A, ...)) to rank q, the
    pieces packed in rank order."""
    if kind == "all_gather":
        return _pack(obj), _meta(obj)
    blk = tree.leaves(obj)[0].shape[0]
    chunks = [tree.map_leaves(lambda x, q=q: x[:, q * blk:(q + 1) * blk], obj) for q in range(w)]
    return torch.cat([_pack(c) for c in chunks]), _meta(chunks[0])


def _recv_numel(kind: str, send: torch.Tensor, w: int) -> int:
    return send.numel() * w if kind == "all_gather" else send.numel()


def _shipped(kind: str, send: torch.Tensor, w: int) -> int:
    """The bytes this rank ships to the other ranks."""
    piece = send.numel() if kind == "all_gather" else send.numel() // w
    return piece * (w - 1)


def _got(recv: torch.Tensor, template, w: int):
    """What arrived: the w ranks' pieces of ``recv`` (views), each unpacked
    into ``template`` and stacked along the agent axis in rank order."""
    n = recv.numel() // w
    return tree.cat([_unpack(recv[p * n:(p + 1) * n], template) for p in range(w)])


def _pinned(n: int) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8, pin_memory=True)


def _exchange(mesh: AgentMesh, kind: str, send: torch.Tensor, recv: torch.Tensor,
              host=None) -> None:
    """The collective on flat ``uint8`` buffers: ``all_gather`` (``send``
    (n,) -> ``recv`` (w * n,), rank order) or ``all_to_all`` (piece q of
    ``send`` to rank q, rank p's piece into piece p of ``recv``). With gloo
    a card's buffers cross through host memory (the radio link's analog):
    a blocking copy into the pinned buffers ``host`` (send, recv; fresh
    ones when None), the one host sync, then the collective and an
    asynchronous copy back. Every later gloo write into ``host`` follows
    the next blocking copy on the same stream, which waits for that copy
    back."""
    op = dist.all_gather_into_tensor if kind == "all_gather" else dist.all_to_all_single
    if mesh.backend == "gloo" and send.is_cuda:
        h_send, h_recv = host or (_pinned(send.numel()), _pinned(recv.numel()))
        h_send.copy_(send)
        op(h_recv, h_send, group=mesh.group)
        recv.copy_(h_recv, non_blocking=True)
    else:
        op(recv, send, group=mesh.group)


def _collective(mesh: AgentMesh, kind: str, obj):
    """``obj`` through one collective, on fresh buffers: (what arrived, the
    bytes this rank shipped to the others)."""
    w = mesh.world_size
    send, template = _put(kind, obj, w)
    recv = send.new_empty(_recv_numel(kind, send, w))
    _exchange(mesh, kind, send, recv)
    return _got(recv, template, w), _shipped(kind, send, w)


def _count(mesh: AgentMesh, name: str, nbytes: int) -> int:
    mesh.shipped[name] = mesh.shipped.get(name, 0) + nbytes
    return nbytes


def all_gather(mesh: AgentMesh, name: str, block):
    """Every rank's ``block`` (leaves (blk, ...)) concatenated along the
    agent axis in rank order, and the bytes this rank shipped (its block
    to each other rank). Counted under ``mesh.shipped[name]``."""
    got, nbytes = _collective(mesh, "all_gather", block)
    return got, _count(mesh, name, nbytes)


def gather_blocks(mesh: AgentMesh, obj):
    """Every rank's block of ``obj`` (leaves (blk, ...)) as one stack on
    rank 0 (``None`` on the others), for tests and the dry run."""
    full, _ = all_gather(mesh, "gather_blocks", obj)
    return full if mesh.rank == 0 else None


# ---------------------------------------------------------------------------
# the sharded step and rounds
# ---------------------------------------------------------------------------


def init_agents(params: vio_mod.VioParams, n_agents: int, mesh: AgentMesh):
    """This rank's block of ``n_agents`` freshly initialized agents: (fs,
    slots), leaves (blk, ...), on the mesh's device."""
    sl = mesh.block(n_agents)
    return vio_mod.init_at_time(params, 0.0, sl.stop - sl.start, mesh.device)


def agent_step(params: vio_mod.VioParams):
    """The per-agent full step, batched over the leading agent axis, run
    eagerly: an IMU batch, then one match-driven visual update. ``(fs,
    slots, imu_times, imu_seqs, imu_w, imu_a, meas_time, meas) -> (fs,
    slots, applied (A,))``. The plain version of :func:`agent_step_fn`."""

    def step(fs, slots, imu_times, imu_seqs, imu_w, imu_a, meas_time,
             meas: pipeline.FrameMeasurement):
        fs = ekf_mod.process_imu_batch_impl(params.ekf_params, fs, imu_times, imu_seqs, imu_w,
                                            imu_a)
        return vio_mod.process_matches(params, fs, slots, meas_time, meas)

    return step


def agent_step_fn(params: vio_mod.VioParams) -> graph.Compiled:
    """:func:`agent_step` compiled, as the reference's ``agent_step_fn``
    returns ``jax.jit(_step)``: one CUDA graph per call on the card, (fs,
    slots) the carry (``utils/graph.py``: the returned state is the
    program's buffers, valid until its next call). Raises on CUDA if TF32
    matmuls are on."""
    return graph.compiled(agent_step(params), "agent_step", n_carry=2)


def sharded_step(params: vio_mod.VioParams, mesh: AgentMesh):
    """The multi-rank step: :func:`agent_step_fn` on this rank's block, no
    collective (the agents are data-parallel). Raises on CUDA if TF32
    matmuls are on."""
    return agent_step_fn(params)


def _run(mesh: AgentMesh, segments, collectives, state: tuple, shipped: dict):
    """A round's segments in order, collective i between segments i and
    i + 1, run where they stand: the plain round, and with NCCL the body of
    its one graph. Segment i takes (state, what collective i - 1 delivered)
    and returns (state, what collective i ships); the last returns (state,
    the round's other outputs). Records each collective's bytes in
    ``shipped``. Returns (state, outputs)."""
    got = None
    for i, seg in enumerate(segments):
        state, put = seg(state, got)
        if i < len(collectives):
            name, kind = collectives[i]
            got, shipped[name] = _collective(mesh, kind, put)
    return state, put


class ShardedRound(graph.Programs):
    """A sharded round compiled (``utils/graph.py``), the counterpart of the
    reference's ``jax.jit`` of its ``shard_map``. Per capture key:

      * NCCL: one CUDA graph of the whole round, its collectives captured
        inside it (the eager first run creates the communicator); a call
        makes no host sync;
      * gloo: one graph per segment, and between two replays the collective
        as a host step on static buffers (:func:`_exchange`: the graph's
        send buffer copied to pinned host memory, the gloo collective, a
        copy into the static receive buffer that the next graph reads), the
        one host sync per collective.

    The first ``n_carry`` program arguments are the carry; ``arrange`` maps
    the public arguments to the program's. A call returns the carry buffers
    and the graphs' outputs, valid until its next call, and adds each
    collective's bytes (fixed by the shapes) to ``mesh.shipped``, as the
    plain round does. A capture or replay that fails raises, naming the
    program; nothing falls back to the plain round."""

    def __init__(self, mesh: AgentMesh, name: str, segments, collectives, n_carry: int,
                 arrange: Callable):
        if mesh.backend not in ("nccl", "gloo"):
            raise ValueError(f"{name}: no compiled round on backend {mesh.backend!r} "
                             "(nccl or gloo)")
        super().__init__(name)
        self.mesh, self.segments, self.collectives = mesh, segments, collectives
        self.n_carry, self.arrange = n_carry, arrange

    def __call__(self, *args):
        dev, bufs, prog = self.get(self.arrange(*args), self._build, n_carry=self.n_carry)
        for i, g in enumerate(prog["graphs"]):
            outs = g(dev)
            if i < len(prog["graphs"]) - 1:
                self._host_step(prog, i, outs[0])
        for name, n in prog["shipped"].items():
            _count(self.mesh, name, n)
        return tuple(bufs[:self.n_carry]) + tuple(outs)

    def _build(self, bufs, label: str) -> dict:
        n, g, segs = self.n_carry, self.graphs, self.segments
        prog = {"shipped": {}, "template": {}, "recv": {}, "host": {}}

        def whole():
            state, outs = _run(self.mesh, segs, self.collectives, bufs, prog["shipped"])
            graph.write_carry(bufs[:n], state[:n], self.name)
            return outs

        def segment(i):
            def body():
                got = None if i == 0 else _got(prog["recv"][i - 1], prog["template"][i - 1],
                                               self.mesh.world_size)
                state, put = segs[i](bufs, got)
                graph.write_carry(bufs[:n], state[:n], self.name)
                if i == len(segs) - 1:
                    return put
                send, prog["template"][i] = _put(self.collectives[i][1], put,
                                                 self.mesh.world_size)
                return (send,)
            return body

        if self.mesh.backend == "nccl":
            prog["graphs"] = [g.graph(label, whole)]
        else:
            prog["graphs"] = [g.graph(f"{label}:{i}", segment(i)) for i in range(len(segs))]
        return prog

    def _host_step(self, prog: dict, i: int, send: torch.Tensor) -> None:
        """Collective i between graphs i and i + 1 (gloo), its static
        receive and pinned host buffers made on its first call."""
        name, kind = self.collectives[i]
        w = self.mesh.world_size
        if i not in prog["recv"]:
            recv = prog["recv"][i] = send.new_empty(_recv_numel(kind, send, w))
            prog["host"][i] = (_pinned(send.numel()), _pinned(recv.numel())) if send.is_cuda \
                else None
            prog["shipped"][name] = _shipped(kind, send, w)
        _exchange(self.mesh, kind, send, prog["recv"][i], prog["host"][i])


def _round(mesh: AgentMesh, name: str, segments, collectives, n_carry: int, compiled: bool,
           arrange: Callable = lambda *args: args):
    """The round of ``segments`` split at ``collectives`` ((name, kind) each):
    the compiled program, or with ``compiled=False`` the plain round, which
    runs the same segments op by op."""
    if compiled:
        return ShardedRound(mesh, name, segments, collectives, n_carry, arrange)

    def plain(*args):
        linalg.require_fp32_matmul(mesh.device, name)
        shipped = {}
        state, outs = _run(mesh, segments, collectives, arrange(*args), shipped)
        for key, nbytes in shipped.items():
            _count(mesh, key, nbytes)
        return tuple(state[:n_carry]) + tuple(outs)

    return plain


def sharded_collab_round(params: vio_mod.VioParams, ccfg: collab.CollabConfig, mesh: AgentMesh,
                         compiled: bool = True):
    """One full-map exchange round over the ranks: each rank extracts its
    block's payloads, one ``all_gather`` (collective ``"payloads"``) stacks
    all A in agent order, and each local agent fuses every peer b = 0..A-1
    in order, its own masked, as ``collab.collaborative_round`` does.

    Returns ``fs_blk -> (fs_blk, n_matches (blk, A))``: compiled, as the
    reference's ``sharded_collab_round`` returns its jitted program
    (:class:`ShardedRound`: ``fs_blk`` the carry; with gloo two graphs
    around the host step), or with ``compiled=False`` the plain round.
    Raises on CUDA if TF32 matmuls are on."""

    def payloads(state, _):
        return state, collab.extract_payload(params, state[0])

    def fuse(state, payloads):
        fs_blk, = state
        blk = fs_blk.cov.shape[0]
        my_ids = torch.arange(mesh.rank * blk, (mesh.rank + 1) * blk, device=mesh.device)
        ns = []
        for b in range(blk * mesh.world_size):
            peer = tree.map_leaves(lambda x: x[b].expand((blk,) + x.shape[1:]), payloads)
            fs_blk, n = collab.fuse_with_peer(params, ccfg, fs_blk, peer, my_ids != b)
            ns.append(n)
        return (fs_blk,), (torch.stack(ns, dim=1),)

    return _round(mesh, "sharded_collab_round", (payloads, fuse), (("payloads", "all_gather"),),
                  1, compiled)


def sharded_collab_round_desc(params: vio_mod.VioParams, ccfg: collab.CollabConfig,
                              words: torch.Tensor, mesh: AgentMesh, compiled: bool = True):
    """Descriptor place recognition + REQUEST_COMM over the ranks, the four
    steps of the reference's mesh round:

      1. one ``all_gather`` of the block's query VLADs (collective
         ``"vlads"``);
      2. each local responder answers the requesters 0..A-1 in order with
         ``database.find_candidate_scored`` (each answer marks a keyframe
         served, which the next requester sees; a self-request is no hit);
      3. one ``all_to_all`` (collective ``"keyframes"``) routes the (blk
         responders, A requesters) grid of keyframes, hits and scores to
         the requesters' ranks as (A responders, blk requesters); a miss
         carries a zero payload, so the shapes are fixed;
      4. each local requester keeps its ``top_k_peers`` best responders
         (``collab.top_k_select``) and fuses them with
         ``collab.fuse_with_peer_desc`` (RANSAC draws keyed on each
         agent's state, ``KeyedSampler()``).

    Returns ``(fs_blk, slots_blk, db_blk) -> (fs_blk, db_blk, hits (blk, A
    responders), n_matches (blk, K))``, equal to the rows of
    ``collab.request_response_round`` on the same agents: compiled, as the
    reference returns its jitted program (:class:`ShardedRound`: ``fs_blk``
    and ``db_blk`` the carry, since the served bitmap threads through the
    requesters; with gloo three graphs around the two host steps), or with
    ``compiled=False`` the plain round. Raises when A exceeds the served
    bitmap (``DbDims.max_agents``), and on CUDA if TF32 matmuls are on."""
    dev = mesh.device

    def vlads(state, _):
        fs_blk, db_blk, slots_blk = state
        a = fs_blk.cov.shape[0] * mesh.world_size
        if a > db_blk.served.shape[-1]:
            raise ValueError(f"{a} agents exceed the served bitmap of {db_blk.served.shape[-1]} "
                             "(raise DbDims.max_agents)")
        return state, collab.query_vlad(words, slots_blk)  # (blk, W, 32)

    def responders(state, vlads):  # vlads (A, W, 32)
        fs_blk, db_blk, slots_blk = state
        blk = fs_blk.cov.shape[0]
        my_ids = torch.arange(mesh.rank * blk, (mesh.rank + 1) * blk, device=dev)
        idx_cols, hit_cols, score_cols = [], [], []
        for r in range(vlads.shape[0]):
            idx, found, score, db_blk = db_mod.find_candidate_scored(
                db_blk, r, vlads[r].expand((blk,) + vlads.shape[1:]), ccfg.pr_score_thr)
            idx_cols.append(idx)
            hit_cols.append(found & (my_ids != r))
            score_cols.append(score)
        hit_grid = torch.stack(hit_cols, 1)  # (blk responders, A requesters)
        kf_grid = tree.map_leaves(lambda x: tree.take(x, torch.stack(idx_cols, 1)), db_blk.payload)
        kf_grid = tree.where(hit_grid, kf_grid, tree.map_leaves(torch.zeros_like, kf_grid))
        # the score-gated ship, responder -> requester
        return (fs_blk, db_blk, slots_blk), (kf_grid, hit_grid, torch.stack(score_cols, 1))

    def fuse(state, got):  # got: (A responders, blk requesters, ...)
        fs_blk, db_blk, slots_blk = state
        kf_by_req, hit_by_req, score_by_req = got
        blk, a = fs_blk.cov.shape[0], hit_by_req.shape[0]
        sel, sel_valid = collab.top_k_select(hit_by_req.T, score_by_req.T, ccfg.top_k_peers)
        ar = torch.arange(blk, device=dev)
        ns = []
        for kk in range(sel.shape[1]):
            b = sel[:, kk].long()
            kf = tree.map_leaves(lambda x: x[b, ar], kf_by_req)
            fs_blk, n, _ = collab.fuse_with_peer_desc(params, ccfg, fs_blk, slots_blk, kf,
                                                      sel_valid[:, kk])
            ns.append(n)
        hits = torch.zeros((blk, a), dtype=torch.int32, device=dev).scatter_reduce(
            1, sel.long(), sel_valid.to(torch.int32), "amax") > 0
        return (fs_blk, db_blk, slots_blk), (hits, torch.stack(ns, dim=1))

    return _round(mesh, "sharded_collab_round_desc", (vlads, responders, fuse),
                  (("vlads", "all_gather"), ("keyframes", "all_to_all")), 2, compiled,
                  lambda fs_blk, slots_blk, db_blk: (fs_blk, db_blk, slots_blk))


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------


def _to_cpu(obj):
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_cpu(v) for v in obj]
    return tree.map_leaves(lambda x: x.cpu(), obj)


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, init_method: str,
               args: tuple, device, timeout_s: float, results) -> None:
    """One rank's process: join the mesh, run ``fn(mesh, *args)``, send its
    result (serialized with ``torch.save``, tensors moved to the CPU) or its
    traceback to the parent."""
    torch.set_num_threads(1)
    mesh = None
    try:
        mesh = make_agent_mesh(backend, init_method, rank, world_size, device, timeout_s)
        out = _to_cpu(fn(mesh, *args))
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def spawn_agents(fn: Callable, world_size: int, backend: str, init_method: str, args: tuple = (),
                 timeout_s: float = 300.0, device=None) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned ranks (one process
    each, ``torch.multiprocessing`` spawn, one CPU thread each) and return
    their results in rank order. ``fn`` must be importable by the children
    (a module-level function of a module that imports no JAX). ``device``:
    each rank's, as :func:`make_agent_mesh` takes it. A rank that raises
    fails the call with its traceback; when ``timeout_s`` runs out (the
    ranks' collectives time out then too) every rank is killed and the call
    raises ``TimeoutError``."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, fn, world_size, backend, init_method, args, device, timeout_s,
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got: Dict[int, Any] = {}
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(got))} did not "
                                   f"finish within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = torch.load(io.BytesIO(payload), weights_only=False)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)
        results.close()
    return [got[r] for r in range(world_size)]
