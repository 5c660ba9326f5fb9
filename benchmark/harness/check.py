"""The judge: what the timed path produced against the plain reference.

The reference (``benchmark/reference``) follows the program frame by frame:
for each sampled frame it takes the program's state from before the frame
(copied inside the window), the benchmark's inputs for that frame, and, for
each later stage, the program's input to that stage (the matches the
program's tracker produced feed the reference's filter step, as a served
model's tokens feed its reference); it computes each stage again and compares
what the program returned. The start is checked whole: the reference makes
the fleet's initial state, its first frame and the vocabulary itself.

Numbers (each compared with the cell's limit in ``benchmark/limits``):

* ``track_off_share`` (image input): the share of the tracker's slots (the
  matches valid on either side, the next state's live features on either
  side, and each agent's next feature id) on which the two sides disagree:
  the feature, its validity or its descriptor's validity differs, or its
  points lie more than ``TOL_PX`` apart.
* ``filter_gap``: over every leaf of the filter step's result (state,
  slots, ``applied``), the worst: for a float leaf the largest difference in
  a column (the last axis: a field of the packed state, a component, a
  covariance column) over the reference's largest magnitude in that column
  (at least ``SCALE_FLOOR`` of the leaf's), for an integer or boolean leaf
  the share of entries that differ; infinite where a value is not finite on
  one side only.
* ``exchange_gap`` (keyframes): the same over the keyframe step's and the
  round's results (database, bookkeeping, selection, state, hits, fused
  matches) and the vocabulary.

The control computes the reference's stages in the next precision below
float32 with TF32 off: TF32. On a card the filter, keyframe and round stages
run with TF32 matmuls; on the CPU, which has none, each matmul's float32
operands are rounded to TF32's 10-bit mantissa first. TF32 touches no
operation of the tracker but RANSAC's small products, so the tracker stage
computes every float32 result in TF32's precision."""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .tree import convert, leaves

INF = float("inf")
SCALE_FLOOR = 1e-6  # a column's scale is at least this share of its leaf's largest magnitude
TOL_PX = 0.01  # two points of one feature closer than this agree (K2's rounding: ~1e-5 px)
MATMULS = {torch.matmul, torch.bmm, torch.mm, torch.einsum, torch.Tensor.matmul,
           torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.Tensor.bmm, torch.Tensor.mm}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero, as the card rounds TF32 operands); others unchanged."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


class _Tf32Matmul(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in MATMULS:
            args = tuple(tf32_round(a) for a in args)
        return func(*args, **kwargs)


class _Tf32Everywhere(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in MATMULS:
            args = tuple(tf32_round(a) for a in args)
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            return tf32_round(out)
        if isinstance(out, tuple) and not hasattr(type(out), "_fields"):
            return tuple(tf32_round(o) for o in out)
        return out


@contextlib.contextmanager
def precision(control: bool, device: torch.device, stage: str):
    """float32 with TF32 off, or for the control the stage in TF32."""
    if not control:
        yield
        return
    if stage == "tracker":
        with _Tf32Everywhere():
            yield
        return
    if device.type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return
    with _Tf32Matmul():
        yield


def leaf_gap(prog, ref) -> tuple:
    """(worst gap over the leaves, its leaf's path) of two trees."""
    pl, rl = leaves(prog), leaves(ref)
    worst, where = 0.0, ""
    for path, p in pl.items():
        r = rl.get(path)
        if r is None or r.shape != p.shape:
            return INF, path
        if p.is_floating_point():
            p64, r64 = p.double(), r.double()
            fp, fr = torch.isfinite(p64), torch.isfinite(r64)
            if bool((fp != fr).any()):
                return INF, path
            both = fp & fr
            d = torch.where(both, (p64 - r64).abs(), 0.0)
            mag = torch.where(both, r64.abs(), 0.0)
            if p.dim() > 1:  # each column (field, component) against its own scale
                d, mag = d.flatten(0, -2).amax(0), mag.flatten(0, -2).amax(0)
            else:
                d, mag = d.amax(), mag.amax()
            scale = torch.clamp(mag, min=SCALE_FLOOR * float(mag.max()) if mag.numel() else 0.0)
            ratio = torch.where(d == 0, 0.0, d / scale)
            g = float(ratio.max()) if ratio.numel() else 0.0
        else:
            g = float((p != r).double().mean()) if p.numel() else 0.0
        if g > worst:
            worst, where = g, path
    return worst, where


def track_gaps(prog_state, prog_matches, ref_state, ref_matches, fx: float) -> np.ndarray:
    """Each tracker slot's gap in pixels (see the module's note)."""
    out = []
    pv, rv = prog_matches.valid, ref_matches.valid
    same = (pv == rv) & (prog_matches.track_id == ref_matches.track_id) & (
        prog_matches.desc_valid == ref_matches.desc_valid)
    d = torch.maximum((prog_matches.cur_pt - ref_matches.cur_pt).abs().amax(-1),
                      (prog_matches.prev_pt - ref_matches.prev_pt).abs().amax(-1)) * fx
    g = torch.where(same, d.double(), INF)
    out.append(g[pv | rv])
    pl, rl = prog_state.ids >= 0, ref_state.ids >= 0
    same = prog_state.ids == ref_state.ids
    d = (prog_state.pts - ref_state.pts).abs().amax(-1)
    g = torch.where(same, d.double(), INF)
    out.append(g[pl | rl])
    out.append(torch.where(prog_state.next_id == ref_state.next_id, 0.0, INF).double())
    return torch.cat(out).cpu().numpy()


class Judge:
    def __init__(self, fleet, ref, ref_pkg: str, prog_pkg: str, device, control: bool = False):
        self.fleet, self.ref, self.device, self.control = fleet, ref, device, control
        self.ref_pkg, self.prog_pkg = ref_pkg, prog_pkg
        self.track, self.filter, self.exchange = [], [], []
        self.words = None

    def _ref(self, obj):
        return convert(obj, self.prog_pkg, self.ref_pkg)

    def _stage(self, stage: str):
        return precision(self.control, self.device, stage)

    def record(self, rec: dict) -> None:
        """Judge one sampled frame (``rec["before"]`` None: the start)."""
        fl, ref = self.fleet, self.ref
        x = fl.ring.frame(rec["k"])
        start = rec.get("before") is None
        if start:
            fs, slots = ref.init(fl.ring.start, self.device)
            if fl.image:
                cfg = fl.config["image"]
                tstate = ref.tracker_zero(cfg["height"], cfg["width"], self.device)
        else:
            b = self._ref(rec["before"])
            fs, slots, tstate = b["fs"], b["slots"], b["tstate"]
        out = self._ref(rec["frame"])
        if fl.image:
            with self._stage("tracker"):
                r_tstate, r_matches = ref.track(tstate, x["image"])
            self.track.append(track_gaps(out["tstate"], out["matches"], r_tstate, r_matches,
                                         float(fl.config["camera"]["fx"])))
            matches = r_matches if start else out["matches"]
        else:
            matches = ref.matches(x["track_id"], x["prev_pt"], x["cur_pt"], x["valid"])
        with self._stage("filter"):
            r = ref.filter(fs, slots, x, matches)
        self.filter.append(leaf_gap((out["fs"], out["slots"], out["applied"]), r))
        if not fl.keyframes:
            return
        if start:
            self.words = ref.vocabulary(x["image"], r_tstate)
            db, kf_meta = ref.db_zero(r[0], r[1])
            self.exchange.append(leaf_gap(rec["words"], self.words))
        else:
            db, kf_meta = b["db"], b["kf_meta"]
        kf = self._ref(rec["keyframe"])
        with self._stage("keyframe"):
            r_kf = ref.keyframe(self.words, out["fs"], out["slots"], db, kf_meta, out["applied"])
        self.exchange.append(leaf_gap((kf["db"], kf["kf_meta"], kf["sel"]), r_kf))
        if "round" in rec:
            rd = self._ref(rec["round"])
            with self._stage("round"):
                r_rd = ref.round(self.words, out["fs"], out["slots"], kf["db"])
            self.exchange.append(leaf_gap((rd["fs"], rd["db"], rd["hits"], rd["n_matches"]), r_rd))

    def numbers(self) -> dict:
        """{name: (value, where)} of the cell's compared numbers."""
        out = {}
        if self.track:
            gaps = np.concatenate(self.track)
            off = gaps > TOL_PX
            out["track_off_share"] = (float(off.mean()) if gaps.size else 0.0,
                                      f"{int(off.sum())} of {gaps.size} slots")
        out["filter_gap"] = max(self.filter, key=lambda g: g[0])
        if self.exchange:
            out["exchange_gap"] = max(self.exchange, key=lambda g: g[0])
        return out
