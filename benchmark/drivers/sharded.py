"""The multi-rank traffic driver: a fleet sharded over ranks, one process and
one card each, exchanging through ``torch.distributed`` (traffic files with
``"driver": "sharded"``; ``ranks`` and ``backend`` name the mesh).

Rank 0 runs in the harness's process on the harness's device; ranks 1.. are
spawned (``torch.multiprocessing``, spawn), rank r on ``cuda:r`` (on the CPU
with ``device`` cpu). Each rank holds a contiguous block of the fleet's
agents: its inputs are rows ``r * blk .. r * blk + blk - 1`` of the one-process
ring, and each frame it runs the program's own entry points on its block,
with no logic of the driver's:

* ``vio.frame_step.CompiledFrameStep`` (the tracker's graphs, then the filter
  step's);
* ``parallel.collab.maybe_add_keyframe_fn``, the compiled keyframe step;
* every ``exchange_every``-th frame ``parallel.mesh.sharded_collab_round_desc``
  (compiled: with NCCL one CUDA graph with its collectives inside).

The vocabulary is trained once, on rank 0, on the whole fleet's frame-0
descriptors (one ``all_gather``), and broadcast: every rank holds the same
words, those the one-process fleet and the reference train.

Rank 0 steers the others through a command queue each, and, in the window,
through a side channel: before it enqueues a round, rank 0 writes into that
round's slot whether the window ends after the next round and which frame
to record for the judge; a rank reads the slot one frame after that round,
once the round has run on its own device (and so after rank 0 wrote it).
Between rounds the ranks run free; no host collective and no added host
wait runs per frame. The window ends after a round.

Each rank's process runs on CPUs of its own: whole cores of its card's NUMA
node, split among the ranks that share the node (:func:`placement`). The
warm-up runs whole exchange cycles until every program is built and then
for ``warmup_s`` seconds more.

The ``Fleet`` the harness reads covers every agent: ``agents``, ``fs`` at the
window's close, ``every``, ``rounds`` (each round's (A, A) hits), ``words``,
``payload_bytes``, ``checkable``, ``state`` / ``restore`` (gathered to rank
0, broadcast back) and ``release``. The ranks' blocks are gathered only at
the judge's sampled frames (after the window) and at the close.

A rank that dies, raises, or stops making progress for ``timeout_s`` (a
collective that waits for a peer that never comes) ends the run with an
error, within two minutes: rank 0 prints it and exits 1; a rank whose parent
is gone exits. Spans (rank 0's calls): ``tracker``, ``filter``, ``keyframe``,
``round``. The traced segment reads the port's own recorder (programs
captured anew with it on, on every rank), not the profiler: it adds to the
harness's trace keys the rounds it ran and the device seconds of the
collectives' transfer (the recorder's ``wire`` stage, per round and
collective the least over the ranks: the last rank to arrive waits for
no one)."""
from __future__ import annotations

import _thread
import os
import queue as queue_mod
import socket
import sys
import threading
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

# the compiled keyframe step: a checkout of the program without it fails here
from x_multi_agent_torch.parallel.collab import maybe_add_keyframe_fn
from x_multi_agent_torch.utils import timing

from ..harness import inputs as inputs_mod
from ..harness.tree import build, clone, leaves, map_tree
from ..harness.window import IN_FLIGHT, Window

STOP_NEVER = 1 << 62
GRACE_S = 20.0  # after an error, how long rank 0 waits for its main thread to raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cpu_list(text: str) -> set:
    """The CPUs of a kernel CPU list such as ``0-7,16-23``."""
    out = set()
    for part in text.strip().split(","):
        if part:
            a, _, b = part.partition("-")
            out.update(range(int(a), int(b or a) + 1))
    return out


def _read(path: str):
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def _card_cpus(index: int, allowed: set) -> set:
    """The allowed CPUs local to card ``index`` (its PCI device's
    ``local_cpulist``); all allowed CPUs where that is not known."""
    p = torch.cuda.get_device_properties(index)
    bus = getattr(p, "pci_bus_id", None)
    text = None if bus is None else _read(
        f"/sys/bus/pci/devices/{p.pci_domain_id:04x}:{bus:02x}:{p.pci_device_id:02x}.0/"
        "local_cpulist")
    return (_cpu_list(text) & allowed if text else set()) or set(allowed)


def placement(world: int, cuda: bool) -> list:
    """Each rank's CPUs, disjoint: the allowed CPUs local to its card (all
    allowed CPUs without a card), in whole cores (a core's hardware threads
    together), split evenly, in rank order, among the ranks whose cards
    share them. A rank whose share would be empty gets the whole set."""
    allowed = os.sched_getaffinity(0)
    local = [_card_cpus(r, allowed) if cuda else set(allowed) for r in range(world)]
    taken, out = set(), [None] * world
    for r in range(world):
        if out[r] is not None:
            continue
        ranks = [q for q in range(world) if local[q] == local[r]]
        free = sorted(local[r] - taken)
        cores = {}
        for c in free:
            key = (_read(f"/sys/devices/system/cpu/cpu{c}/topology/physical_package_id"),
                   _read(f"/sys/devices/system/cpu/cpu{c}/topology/core_id"))
            cores.setdefault(c if None in key else key, set()).add(c)
        cores = sorted(cores.values(), key=min)
        n = len(cores) // len(ranks)
        for i, q in enumerate(ranks):
            out[q] = set().union(*cores[i * n:(i + 1) * n]) if n else set(local[r])
            taken |= out[q]
    return out


def _pin(cpus: set) -> None:
    """Every thread of this process onto ``cpus`` (threads started later
    inherit it)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:  # a thread that ended meanwhile
            pass


def _rows(ring, sl: slice, copy: bool):
    """Rows ``sl`` of an image ring's agent-indexed leaves: views, or copies
    (so that the whole ring can go)."""
    def take(x):
        return x[:, sl].clone() if copy else x[:, sl]

    return ring._replace(frames=take(ring.frames), times=take(ring.times), seqs=take(ring.seqs),
                         w_m=take(ring.w_m), a_m=take(ring.a_m),
                         start=tuple(x[sl].clone() for x in ring.start))


def _nothing() -> None:
    pass


def _slot(k: int, every: int) -> int:
    """The side channel's slot of the round at frame ``k``: two, in turn
    (rank 0 cannot write a round's slot again before every rank has read
    it: it waits for the round two cycles back to end before its round)."""
    return 2 * ((k // every) % 2)


class _NoSpans:
    def wrap(self, name, fn):
        return fn


class Rank:
    """One rank's block of the fleet: its inputs, state, programs and
    records, driven frame by frame."""

    def __init__(self, mesh, config: dict, mix: dict, seed: int, spans=None, ring=None):
        from x_multi_agent_torch.parallel import collab
        from x_multi_agent_torch.place_recognition import database as db_mod
        from x_multi_agent_torch.vio import vio as vio_mod
        from x_multi_agent_torch.vision import camera as cam_mod
        from x_multi_agent_torch.vision import tracker as trk

        spans = spans or _NoSpans()
        self.mesh, self.config, self.mix = mesh, config, mix
        self.device = device = mesh.device
        self.agents = int(mix["agents"])
        self.sl = mesh.block(self.agents)
        blk = self.sl.stop - self.sl.start
        self.params = params = build(vio_mod.VioParams, config["vio"])
        self.ccfg = build(collab.CollabConfig, config["collab"])
        self.db_dims = build(db_mod.DbDims, config["keyframe_db"])
        self.tparams = build(trk.TrackerParams, config["tracker"])
        # rank 0 keeps the whole ring (the judge reads it) and views its rows
        full = ring if ring is not None else inputs_mod.make_ring(mix, self.agents, config, seed,
                                                                  device)
        self.ring = _rows(full, self.sl, copy=ring is None)
        del full
        p0, v0, q0 = (x.cpu().numpy() for x in self.ring.start)
        self.fs, self.slots = vio_mod.init_at_time(params, 0.0, blk, device, p=p0, v=v0, q=q0)
        h, w = config["image"]["height"], config["image"]["width"]
        self.tstate = trk.TrackerState.zero(self.tparams, blk, h, w, device=device)
        self.cam = build(cam_mod.Camera, config["camera"])
        self.spans = spans
        self.every = int(mix["exchange_every"])
        self.words = self.db = self.kf_meta = self.round = None
        self.compile()
        self.rounds = []  # (frame, hits (blk, A)) of each round run
        self.marks = []  # (start, end) marks around each round run
        self.records = {}  # frame -> record of this rank's block
        self.beat = _nothing  # rank 0's watchdog: progress

    def compile(self) -> None:
        """The rank's programs, new (their graphs are captured at their first
        calls): the frame step, the keyframe step and, once the vocabulary
        exists, the round; each call in the harness's span of its layer."""
        from x_multi_agent_torch.vio.frame_step import CompiledFrameStep

        spans = self.spans
        self.step = CompiledFrameStep(self.params, self.tparams, self.cam,
                                      seed=int(self.config["tracker_seed"]))
        self.graphs = [self.step.tracker.graphs, self.step.step.graphs]
        self.tracker_graphs = self.step.tracker.graphs
        self.step.tracker = spans.wrap("tracker", self.step.tracker)
        self.step.step = spans.wrap("filter", self.step.step)
        keyframe = maybe_add_keyframe_fn(self.params, self.db_dims)
        self.graphs.append(keyframe.graphs)
        self.keyframe = spans.wrap("keyframe", keyframe)
        if self.words is not None:
            self._round_program()

    def _round_program(self) -> None:
        from x_multi_agent_torch.parallel import mesh as mesh_mod

        program = mesh_mod.sharded_collab_round_desc(self.params, self.ccfg, self.words, self.mesh)
        self.graphs.append(program.graphs)
        self.round = self.spans.wrap("round", program)

    def recompile(self) -> None:
        """New programs with the port's recorder on: their graphs hold its
        device stamps (the traced segment's)."""
        timing.enable()
        self.compile()

    # -- one frame --------------------------------------------------------

    def state(self):
        return clone((self.tstate, self.fs, self.slots, self.db, self.kf_meta))

    def restore(self, st) -> None:
        self.tstate, self.fs, self.slots, self.db, self.kf_meta = clone(st)

    def frame(self, k: int, record: bool = False) -> None:
        """Frame ``k`` of this rank's block: one fleet frame of the program's
        recorder (``utils/timing.frame``) around its calls."""
        with timing.frame():
            self._frame(k, record)
        self.beat()

    def _frame(self, k: int, record: bool) -> None:
        rec = None
        if record:
            rec = self.records[k] = {"k": k}
            if k:
                rec["before"] = dict(zip(("tstate", "fs", "slots", "db", "kf_meta"), self.state()))
        x = self.ring.frame(k)
        self.tstate, self.fs, self.slots, matches, applied = self.step(
            self.tstate, self.fs, self.slots, x["image"], x["times"], x["seqs"], x["w_m"],
            x["a_m"], x["meas_time"])
        if rec is not None:
            rec["frame"] = clone({"tstate": self.tstate, "fs": self.fs, "slots": self.slots,
                                  "matches": matches, "applied": applied})
        if self.words is None:
            self._vocabulary(x["image"], rec)
        self.db, self.kf_meta, sel = self.keyframe(self.db, self.kf_meta, self.words, self.fs,
                                                   self.slots, applied)
        if rec is not None:
            rec["keyframe"] = clone({"db": self.db, "kf_meta": self.kf_meta, "sel": sel})
        if self.checkable(k):
            start = self._mark()
            self.fs, self.db, hits, n = self.round(self.fs, self.slots, self.db)
            self.marks.append((start, self._mark()))
            self.rounds.append((k, hits.clone()))
            if rec is not None:
                rec["round"] = clone({"fs": self.fs, "db": self.db, "hits": hits, "n_matches": n})

    def checkable(self, k: int) -> bool:
        return (k + 1) % self.every == 0

    def _mark(self):
        """A device mark on the card (a CUDA event), the host clock on the CPU."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def cycles(self) -> dict:
        """Device milliseconds of the rounds marked since the marks were
        last dropped: each round, and each cycle (from a round's end to the
        next round's end), in order."""
        def ms(a, b):
            if self.device.type != "cuda":
                return (b - a) * 1e3
            b.synchronize()
            return a.elapsed_time(b)

        ends = [e for _, e in self.marks]
        return {"round": [ms(a, b) for a, b in self.marks],
                "cycle": [ms(a, b) for a, b in zip(ends, ends[1:])]}

    def _vocabulary(self, image, rec) -> None:
        """The words from the whole fleet's descriptors at its live features
        after frame 0 (gathered; trained on rank 0, broadcast), an empty
        keyframe database and the compiled round."""
        import torch.distributed as dist
        from x_multi_agent_torch.parallel import collab
        from x_multi_agent_torch.parallel import mesh as mesh_mod
        from x_multi_agent_torch.place_recognition import database as db_mod
        from x_multi_agent_torch.place_recognition import descriptors
        from x_multi_agent_torch.place_recognition.vocabulary import train_kmajority

        d0, ok0 = descriptors.compute(image, self.tstate.pts, self.tstate.ids >= 0)
        (d_all, ok_all), _ = mesh_mod.all_gather(self.mesh, "vocabulary", (d0, ok0))
        voc = self.config["vocabulary"]
        words = torch.empty((voc["words"], 32), dtype=torch.uint8, device=self.device)
        if self.mesh.rank == 0:
            trained = train_kmajority(d_all[ok_all].cpu().numpy(), voc["words"], seed=voc["seed"])
            words.copy_(torch.from_numpy(np.ascontiguousarray(trained.words)))
        dist.broadcast(words, 0, group=self.mesh.group)
        self.words = words
        proto = collab.extract_payload_desc(self.params, self.fs, self.slots)
        self.db = db_mod.KeyframeDB.zero(self.db_dims, proto)
        self.kf_meta = collab.KfMeta.zero(self.fs.cov.shape[0], self.fs.cov.dtype, self.device)
        self._round_program()
        if rec is not None:
            rec["words"] = words.clone()

    # -- what rank 0 asks of every rank ------------------------------------

    def run(self, k0: int, k1: int, record=()) -> int:
        for k in range(k0, k1):
            self.frame(k, k in record)
        return self.tracker_graphs.captured

    def recorded(self, k0: int, k1: int) -> list:
        """Frames ``k0``..``k1`` - 1 recorded by the port's recorder; the
        ``wire`` stages' ms (:func:`_wires`)."""
        timing.start()
        self.run(k0, k1)
        rec = timing.collect()
        timing.disable()
        return _wires(rec)

    def take_keep_branch(self, k: int) -> None:
        """The tracker's branch without detection, on a frame that repeats
        the last image (state put back after)."""
        saved = self.state()
        x = self.ring.frame(k)
        image = self.ring.frame(k - 1)["image"]
        self.step(self.tstate, self.fs, self.slots, image, x["times"], x["seqs"], x["w_m"],
                  x["a_m"], x["meas_time"])
        self.restore(saved)

    def free_run(self, first: int, ctl) -> tuple:
        """Frames ``first``.. until the side channel says stop: one frame
        after each round, once that round has run on this device, it reads
        the round's slot of ``ctl`` (the frame after which to stop, the next
        frame to record). Returns (the next frame's index, :meth:`cycles`)."""
        k, rec_at, stop_at, pending = first, -1, STOP_NEVER, None
        self.marks = []
        while True:
            self.frame(k, k == rec_at)
            if pending is not None:
                done, slot = pending
                if self.device.type == "cuda":
                    done.synchronize()  # mostly passed already: the frame waits on its gate
                stop_at, rec_at = int(ctl[slot]), int(ctl[slot + 1])
                pending = None
            if self.checkable(k):
                if k + 1 >= stop_at:
                    return k + 1, self.cycles()
                pending = (self.marks[-1][1], _slot(k, self.every))
            k += 1

    def gather(self, obj):
        """``obj`` (leaves (blk, ...)) of every rank, stacked in agent order."""
        from x_multi_agent_torch.parallel import mesh as mesh_mod

        got, _ = mesh_mod.all_gather(self.mesh, "gather", obj)
        return got

    def gathered_state(self):
        """The whole fleet's state between frames, on every rank (the parts
        that exist: no database before frame 0)."""
        st = self.state()
        got = iter(self.gather(tuple(x for x in st if x is not None)))
        return tuple(None if x is None else next(got) for x in st)

    def take_rows(self, full=None) -> None:
        """Take this rank's rows of the whole fleet's state ``full`` (given
        on rank 0; broadcast from there)."""
        import torch.distributed as dist

        w = self.mesh.world_size
        st = self.state()
        if full is None:
            full = map_tree(lambda t: t.new_empty((t.shape[0] * w,) + t.shape[1:]), st)
        for t in leaves(full).values():
            dist.broadcast(t, 0, group=self.mesh.group)
        self.restore(map_tree(lambda t: t[self.sl], full))

    def close(self, since: int):
        """Gather the close: the state, the rounds' hits from frame ``since``
        on, each record (frames in order). Returns (fs, [(k, hits)], {k: rec})
        on every rank."""
        fs = self.gather(self.fs)
        ks = [k for k, _ in self.rounds if k >= since]
        hits = (self.gather(torch.stack([h for k, h in self.rounds if k >= since], 1))
                if ks else None)
        rounds = [(k, hits[:, i]) for i, k in enumerate(ks)]
        records = {}
        for k in sorted(self.records):
            rec = self.records[k]
            keys = [key for key in ("before", "frame", "keyframe", "round") if key in rec]
            parts = self.gather(tuple(tuple(rec[key][f] for f in sorted(rec[key])) for key in keys))
            full = {"k": k, "before": None}
            for key, part in zip(keys, parts):
                full[key] = dict(zip(sorted(rec[key]), part))
            if "words" in rec:
                full["words"] = rec["words"]
            records[k] = full
        self.records = {}
        return fs, rounds, records


# ---------------------------------------------------------------------------
# ranks 1..: the spawned processes
# ---------------------------------------------------------------------------


def _watch_parent(parent: int) -> None:
    while True:
        if os.getppid() != parent:
            os._exit(3)
        time.sleep(1.0)


def _rank_main(rank: int, world: int, backend: str, init: str, device: str, config: dict,
               mix: dict, seed: int, commands, results, ctl, timeout_s: float, parent: int,
               cpus):
    if cpus:
        _pin(cpus)
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    torch.set_num_threads(1)
    try:
        from x_multi_agent_torch.parallel import mesh as mesh_mod

        dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = bool(config["precision"]["tf32"])
            torch.backends.cudnn.allow_tf32 = bool(config["precision"]["tf32"])
        mesh = mesh_mod.make_agent_mesh(backend, init, rank, world, dev, timeout_s)
        me = Rank(mesh, config, mix, seed)
        results.put((rank, "ready", None))
        while True:
            cmd, *args = commands.get()
            if cmd == "stop":
                break
            if cmd == "call":  # how the tests break one rank's program: fn(rank object)
                args[0](me)
                out = None
            elif cmd == "free_run":
                out = me.free_run(args[0], ctl)
            else:
                out = getattr(me, cmd)(*args)
            if cmd in ("close", "gathered_state"):
                out = None  # what was gathered is rank 0's
            results.put((rank, "done", out))
        results.put((rank, "stopping", None))
        import gc

        import torch.distributed as dist

        del me  # the graphs that hold the communicator's kernels go first
        gc.collect()
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        time.sleep(1.0)
        os._exit(1)


# ---------------------------------------------------------------------------
# rank 0: the fleet the harness drives
# ---------------------------------------------------------------------------


class Fleet:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device, spans,
                 make_ring=inputs_mod.make_ring):
        import torch.distributed as dist

        from x_multi_agent_torch.parallel import mesh as mesh_mod

        self.config, self.mix, self.device = config, mix, device
        self.agents = int(mix["agents"])
        self.world = int(mix["ranks"])
        self.every = int(mix["exchange_every"])
        self.keyframes, self.image = True, True
        self.timeout_s = float(mix.get("timeout_s", 90.0))
        backend = mix["backend"] if device.type == "cuda" else "gloo"
        init = f"tcp://localhost:{_free_port()}"
        self._error = None
        self._stopping = self._closed = self.warm = False
        self._beat = time.monotonic()
        self._messages = queue_mod.Queue()
        ctx = torch.multiprocessing.get_context("spawn")
        self.ctl = ctx.RawArray("q", [STOP_NEVER, -1] * 2)
        self._results = ctx.Queue()
        self._commands = [ctx.Queue() for _ in range(self.world)]
        dev_kind = "cuda" if device.type == "cuda" else str(device)
        os.environ.setdefault("NCCL_RUNTIME_CONNECT", "0")  # every connection at init
        cpus = placement(self.world, True) if device.type == "cuda" else [None] * self.world
        self._procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, self.world, backend, init, dev_kind, config, mix, seed, self._commands[r],
            self._results, self.ctl, self.timeout_s, os.getpid(), cpus[r]))
            for r in range(1, self.world)]
        for p in self._procs:
            p.start()
        if cpus[0]:  # after the spawns, which place themselves
            _pin(cpus[0])
            print(f"sharded driver: the ranks' CPUs {[sorted(c) for c in cpus]}", file=sys.stderr)
        threading.Thread(target=self._watch, daemon=True).start()
        sys.excepthook = _exit_on_error
        self.ring = make_ring(mix, self.agents, config, seed, device)
        mesh = mesh_mod.make_agent_mesh(backend, init, 0, self.world, device, self.timeout_s)
        self._dist = dist
        self.me = Rank(mesh, config, mix, seed, spans, ring=self.ring)
        self.me.beat = self.beat
        self.params, self.ccfg = self.me.params, self.me.ccfg
        self.graphs = self.me.graphs
        self._wait("ready")
        self.fs_close = None
        self.rounds = []
        self.judged = []

    # -- the ranks ---------------------------------------------------------

    def _watch(self) -> None:
        """Rank 0's watchdog: passes the ranks' messages to the main thread;
        a rank that failed or died, or no frame finished for ``timeout_s``
        (three times that before the window: builds and captures), ends the
        run."""
        while not self._closed:
            try:
                msg = self._results.get(timeout=1.0)
            except queue_mod.Empty:
                msg = None
            except (EOFError, OSError):
                return
            if msg is not None and msg[1] == "error":
                self._fail(f"rank {msg[0]} failed:\n{msg[2]}")
            elif msg is not None:
                self._messages.put(msg)
            if self._error is not None:
                continue
            dead = [r for r, p in enumerate(self._procs, 1) if p.exitcode not in (None, 0)]
            if dead and not self._stopping:
                self._fail(f"rank(s) {dead} died (exit codes "
                           f"{[self._procs[r - 1].exitcode for r in dead]})")
            limit = self.timeout_s * (1 if self.warm else 3)
            if time.monotonic() - self._beat > limit:
                self._fail(f"no frame finished for {limit:.0f} s: a collective waits for a "
                           "rank that does not come")

    def _fail(self, why: str) -> None:
        self._error = why
        os.write(2, f"sharded driver: {why}\n".encode(errors="replace"))
        _thread.interrupt_main()
        time.sleep(GRACE_S)  # the main thread raises where it can; else it is stuck on the card
        os.write(2, b"sharded driver: ending the run\n")
        os._exit(1)

    def beat(self) -> None:
        self._beat = time.monotonic()

    def _send(self, cmd: str, *args) -> None:
        for q in self._commands[1:]:
            q.put((cmd,) + args)

    def _wait(self, kind: str = "done") -> list:
        """Each other rank's reply to the last command."""
        got = {}
        while len(got) < self.world - 1:
            if self._error:
                raise RuntimeError(self._error)
            try:
                rank, what, out = self._messages.get(timeout=1.0)
            except queue_mod.Empty:
                continue
            if what == kind:
                got[rank] = out
        self.beat()
        return [got[r] for r in sorted(got)]

    def on_rank(self, rank: int, fn) -> None:
        """Call ``fn(rank object)`` on rank ``rank`` (0: here): the warm-up's
        branch without detection, and how the tests break one rank's
        program. ``fn`` pickles (a module-level function or class)."""
        if rank == 0:
            fn(self.me)
            return
        self._commands[rank].put(("call", fn))
        for r in range(1, self.world):
            if r != rank:
                self._commands[r].put(("run", 0, 0, ()))
        self._wait()

    def everywhere(self, cmd: str, *args):
        """``cmd`` on every rank (here as well); rank 0's result."""
        self._send(cmd, *args)
        out = getattr(self.me, cmd)(*args)
        others = self._wait()
        return out, others

    # -- what the harness reads --------------------------------------------

    @property
    def fs(self):
        return self.fs_close

    @property
    def words(self):
        return self.me.words

    def frame(self, k: int, record=None) -> None:
        """Rank 0's frame ``k`` (the others run theirs on their own)."""
        self.me.frame(k, record is not None)

    def checkable(self, k: int) -> bool:
        return self.me.checkable(k)

    def payload_bytes(self) -> int:
        from ..harness.tree import leaves

        return sum(int(np.prod(x.shape[2:])) * x.element_size()
                   for x in leaves(self.me.db.payload).values())

    def state(self):
        """The whole fleet's state between frames, gathered here."""
        st, _ = self.everywhere("gathered_state")
        return st

    def restore(self, state) -> None:
        """Every rank takes its rows of a state from :meth:`state`."""
        self._send("take_rows", None)
        self.me.take_rows(state)
        self._wait()

    def close(self, since: int) -> list:
        """Gather the close (after the window): the state, the rounds' hits
        and the records. Returns the records in frame order."""
        (fs, rounds, records), _ = self.everywhere("close", since)
        self.fs_close, self.rounds = fs, rounds
        self.judged = [records[k] for k in sorted(records)]
        return self.judged

    def release(self) -> None:
        """Stop the ranks and drop rank 0's programs and state; the ring,
        the close and the records stay for the judge."""
        if self._closed:
            return
        import gc

        self._stopping = True
        self._send("stop")
        self._wait("stopping")
        # the graphs that hold the communicator's kernels go first
        self.me = SimpleNamespace(words=self.me.words, db=self.me.db)
        self.graphs = None
        gc.collect()
        self.beat()
        self._dist.destroy_process_group()
        for p in self._procs:
            p.join(10.0)
            if p.is_alive():
                p.kill()
        self._closed = True


def _exit_on_error(kind, value, tb) -> None:
    """Rank 0's ``sys.excepthook``: an uncaught error ends the process at
    once (the ranks' collectives would otherwise hold it at exit). The
    traceback goes to the standard error's descriptor directly:
    ``torch.distributed``'s own hook calls this one with ``sys.stderr``
    redirected into a buffer."""
    text = "".join(traceback.format_exception(kind, value, tb))
    os.write(2, f"sharded driver: rank 0 failed:\n{text}".encode(errors="replace"))
    os._exit(1)


# ---------------------------------------------------------------------------
# the hooks: warm-up, window, traced segment, reference
# ---------------------------------------------------------------------------


def _cycles(n: int, every: int) -> int:
    """``n`` frames rounded up to whole exchange cycles."""
    return -(-n // every) * every


def _summary(c: dict) -> str:
    """A rank's rounds and cycles (:meth:`Rank.cycles`) in a few numbers:
    medians, and the cycles' medians over each fifth of them in turn."""
    def med(x):
        return f"{float(np.median(x)):.2f}" if len(x) else "-"

    cyc = c["cycle"]
    fifths = [cyc[i * len(cyc) // 5:(i + 1) * len(cyc) // 5] for i in range(5)]
    return (f"{len(c['round'])} rounds, round ms median {med(c['round'])}, cycle ms median "
            f"{med(cyc)} (by fifths {', '.join(med(f) for f in fifths)})")


def warm_up(fleet, clock, n_min: int, n_max: int, record0: dict) -> int:
    """Frames 0.. in whole exchange cycles on every rank until every program
    is built: at least ``n_min`` frames, and until each rank's tracker has
    captured both branches of its detection gate (at most ``n_max`` frames;
    then a rank that lacks the branch without detection takes it on a frame
    that repeats the last image, its state put back); then whole cycles for
    the traffic's ``warmup_s`` seconds more. Frame 0's records, gathered,
    fill ``record0``. Returns the next frame's index."""
    every = fleet.every
    k = _cycles(n_min, every)
    caps, others = fleet.everywhere("run", 0, k, (0,))
    caps = [caps] + others
    while min(caps) < 3 and k < n_max:
        caps, others = fleet.everywhere("run", k, k + every, ())
        caps = [caps] + others
        k += every
    for r, c in enumerate(caps):
        if c < 3:
            fleet.on_rank(r, _KeepBranch(k))
    fleet.me.marks = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < float(fleet.mix.get("warmup_s", 0.0)):
        fleet.everywhere("run", k, k + every, ())
        k += every
    print(f"sharded driver: warm-up's last {time.perf_counter() - t0:.1f} s, rank 0: "
          f"{_summary(fleet.me.cycles())}", file=sys.stderr)
    recs = fleet.close(0)
    record0.update(recs[0])
    fleet.fs_close, fleet.rounds = None, []
    clock.sync()
    fleet.warm = True
    return k


class _KeepBranch:
    def __init__(self, k: int):
        self.k = k

    def __call__(self, rank) -> None:
        rank.take_keep_branch(self.k)


def window(fleet, clock, first: int, seconds: float, sample_at: list) -> Window:
    """Frames ``first``.. on every rank, two in flight on rank 0, in whole
    exchange cycles: at the first round after ``seconds`` of rank 0's host
    clock the window has one cycle left (the ranks read of its end a frame
    after that round), and it ends after a round. A time in ``sample_at`` has the round frame
    of the next cycle recorded for the judge (each rank copies its block's
    state before it and its stages' results). The ranks' records, the
    close and the rounds' hits are gathered after the window."""
    every = fleet.every
    fleet.ctl[:] = [STOP_NEVER, -1] * 2
    fleet._send("free_run", first)
    me = fleet.me
    me.marks = []
    pending = sorted(sample_at)
    starts, ends = [], []
    k, rec_at, stop_at = first, -1, STOP_NEVER
    clock.sync()
    t0 = time.perf_counter()
    while True:
        if len(ends) >= IN_FLIGHT:
            clock.wait(ends[-IN_FLIGHT])
        if me.checkable(k):  # before the round is enqueued: its slot of the side channel
            elapsed, nxt = time.perf_counter() - t0, -1
            if stop_at == STOP_NEVER and elapsed >= seconds:
                stop_at = k + every + 1  # the ranks read it a frame after this round
            elif stop_at == STOP_NEVER and pending and elapsed >= pending[0]:
                pending.pop(0)
                nxt = k + every
            slot = _slot(k, every)
            fleet.ctl[slot], fleet.ctl[slot + 1] = stop_at, nxt
        starts.append(clock.mark())
        me.frame(k, k == rec_at)
        ends.append(clock.mark())
        fleet.beat()
        if me.checkable(k):
            rec_at = nxt
            if k + 1 >= stop_at:
                break
        k += 1
    clock.sync()
    cycles = [me.cycles()] + [c for _, c in fleet._wait()]
    for r, c in enumerate(cycles):
        print(f"sharded driver: window, rank {r}: {_summary(c)}", file=sys.stderr)
    records = fleet.close(first)
    frame_ms = [clock.ms(a, b) for a, b in zip(starts, ends)]
    return Window(first, len(frame_ms), clock.ms(starts[0], ends[-1]) / 1e3, frame_ms, records)


def segment(fleet, clock, first: int, n_frames: int, kernels) -> dict:
    """The traced segment, from the port's recorder (no profiler: CUPTI's
    trace of rank 0's graphs, their collectives inside, stalled the ranks on
    four cards). Every rank compiles its programs anew with the recorder on
    and runs whole exchange cycles twice: first the captures, then the
    recorded frames, two in flight on rank 0 as in the window. Returns the
    harness's trace keys (``busy_s``: the recorded graphs' device time;
    ``device_ops``: device seconds per graph; ``idle_gaps``: device gaps by
    the host span open at their middle) and ``rounds``, ``collective_s``
    (the collectives' transfer: per round and collective the least over the
    ranks of the device seconds from its ``wire`` stamp to the next
    segment's, the last rank to arrive waiting for no one), ``wait_s`` (rank
    0's collectives beyond that: waiting for the other ranks), ``stage_s``,
    ``counters`` (rank 0's recorder, over the frames)."""
    n = _cycles(n_frames, fleet.every)
    fleet.everywhere("recompile")
    fleet.everywhere("run", first, first + n, ())
    fleet._send("recorded", first + n, first + 2 * n)
    timing.start()
    ends = []
    clock.sync()
    t0 = time.perf_counter()
    for k in range(first + n, first + 2 * n):
        if len(ends) >= IN_FLIGHT:
            clock.wait(ends[-IN_FLIGHT])
        fleet.frame(k)
        ends.append(clock.mark())
    clock.sync()
    wall = time.perf_counter() - t0
    rec = timing.collect()
    timing.disable()
    wires = [_wires(rec)] + fleet._wait()
    rounds = n // fleet.every
    if any(len(w) != len(wires[0]) for w in wires):
        raise RuntimeError(f"the ranks recorded {[len(w) for w in wires]} collectives")
    transfer = sum(min(w[i] for w in wires) for i in range(len(wires[0])))
    wait = sum(wires[0]) - transfer
    per_round = {k: round(v / rounds, 3) for k, v in rec["stage_ms"].items()}
    print(f"segment {n} frames, {rounds} rounds: rank 0 busy {rec['busy_ms']:.1f} ms and "
          f"gaps {rec['gap_total_ms']:.1f} ms of {wall * 1e3:.1f}; stage ms per round {per_round}; "
          f"collectives per round: transfer {transfer / rounds:.3f} ms, rank 0's wait "
          f"{wait / rounds:.3f} ms; counters {rec['counters']}", file=sys.stderr)

    def top(table: dict) -> list:
        return [[k, v / 1e3] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:10]]

    return {"frames": n, "window_s": wall, "busy_s": rec["busy_ms"] / 1e3,
            "device_events": None, "launch_calls": None, "graph_launches": rec["graph_calls"],
            "dropped": bool(rec["lost_stamps"] or rec["unmatched"]), "kernel_ms": {},
            "kernel_launches": {}, "live_features": [], "device_ops": top(rec["graph_ms"]),
            "idle_gaps": top(rec["gap_ms"]), "rounds": rounds, "collective_s": transfer / 1e3,
            "wait_s": wait / 1e3, "stage_s": {k: v / 1e3 for k, v in rec["stage_ms"].items()},
            "counters": rec["counters"]}


def _wires(rec: dict) -> list:
    """Each collective's ``wire`` stage in ms, in the order they ran, from
    a recording's graph intervals (stamps on the device)."""
    out = []
    for _, _, _, end, stages in rec["intervals"]:
        ts = [t for _, t in stages[1:]] + [end]
        out += [(e - t) / 1e6 for (label, t), e in zip(stages, ts) if label == "wire"]
    return out


def Reference(config: dict, agents: int):
    """The frozen reference (``reference/steps.py``) with the mended fusion
    (``reference/mended_ci.py``) in its round."""
    from ..reference.mended_ci import MendedReference

    return MendedReference(config, agents)
