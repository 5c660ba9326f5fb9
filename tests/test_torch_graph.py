"""PyTorch port: the compiled main-path programs (``utils/graph.py``).

On the CPU the compiled programs run their plain path (the function on the
staged buffers, no graph), so these tests hold:

* capture safety: a witness (a ``TorchDispatchMode``, with ``torch.tensor``
  and ``torch.as_tensor`` patched) over the filter step and the tracker's
  three graph segments finds no host read of a device value, no tensor from
  host data, no data-dependent shape, no host-checked solve and no batched
  solve that the card runs through MAGMA;
* the compiled filter step (``mesh.agent_step_fn``) and
  ``track_frame_batch_jit`` against the reference's jitted counterparts in
  float64 (integers and booleans exactly);
* the wrapper's carry rule and capture keys;
* on a card (``gpu``-marked, skipped here): graphs against the eager
  programs bit for bit, a capture failure raising, the kernels' launch
  counts on replay.

The JAX package is imported inside the tests that need it, so the card's
machine (no JAX) runs the ``gpu`` tests with ``python -m pytest
--noconftest -m gpu tests/test_torch_graph.py``.
"""
import dataclasses
import traceback
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from x_multi_agent_torch import configs
from x_multi_agent_torch.parallel import mesh as tmesh
from x_multi_agent_torch.utils import bench as tbench
from x_multi_agent_torch.utils import graph, tree
from x_multi_agent_torch.vio import pipeline as tpipe
from x_multi_agent_torch.vio import vio as tvio
from x_multi_agent_torch.vio.frame_step import CompiledFrameStep, frame_step
from x_multi_agent_torch.vision import fast, lk
from x_multi_agent_torch.vision import tracker as ttrk

CPU = torch.device("cpu")
A, STEPS, H, W = 2, 4, 120, 160

# aten ops a CUDA graph cannot hold: a host read of a device value, a
# host-checked solve, an output shape that depends on the data, and the
# batched solves the card runs through MAGMA, which allocates during the call
_HOST_OPS = {"_local_scalar_dense", "_linalg_check_errors", "nonzero", "masked_select",
             "unique", "_unique", "_unique2", "unique_dim", "unique_consecutive", "bincount",
             "repeat_interleave", "equal", "is_nonzero", "cholesky_solve", "_cholesky_solve_helper",
             "cholesky_inverse", "linalg_lu_solve", "lu_solve", "_linalg_eigh"}


class CaptureWitness(TorchDispatchMode):
    """Records every operation of its block that would break a CUDA-graph
    capture: the ops above, boolean-mask indexing, a tensor built from host
    data (``torch.tensor`` / ``torch.as_tensor`` of non-tensor data,
    patched for the block, ``lift_fresh`` of more than a scalar, and a
    Python scalar put through an index, ``x[idx] = 1``)."""

    def __init__(self):
        super().__init__()
        self.found = []

    def _hit(self, what):
        self.found.append((what, "".join(traceback.format_stack(limit=10)[:-2])))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if name in _HOST_OPS:
            self._hit(name)
        elif name == "index" and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                     for i in args[1] if i is not None):
            self._hit("boolean-mask index")
        elif name in ("lift_fresh", "lift_fresh_copy") and args[0].dim() > 0:
            self._hit("tensor from host data")
        elif (name in ("index_put", "index_put_", "_index_put_impl_") and args[2].dim() == 0
              and not args[2]._is_view()):
            # x[idx] = scalar: the scalar becomes a host tensor that the card
            # copies in during the call (values broadcast from a tensor
            # arrive as a view)
            self._hit("a scalar put through an index")
        return func(*args, **(kwargs or {}))

    def __enter__(self):
        self._saved = (torch.tensor, torch.as_tensor)
        tensor, as_tensor = self._saved

        def from_host(make):
            def build(data, *a, **k):
                if not isinstance(data, torch.Tensor):
                    self._hit(f"torch.{make.__name__} of host data")
                return make(data, *a, **k)
            return build

        torch.tensor, torch.as_tensor = from_host(tensor), from_host(as_tensor)
        return super().__enter__()

    def __exit__(self, *exc):
        torch.tensor, torch.as_tensor = self._saved
        return super().__exit__(*exc)

    def assert_clean(self):
        assert not self.found, "capture-unsafe operations:\n" + "\n".join(
            f"== {what}\n{where}" for what, where in self.found)


def _match_windows(tp, dtype=torch.float64):
    """Two consecutive windows of the bench's match inputs at A agents,
    per step: [(times, seqs, w, a, meas_time, matches)]."""
    rng = np.random.default_rng(0)
    out = []
    for frame0 in (0, STEPS):
        x = tbench.match_inputs_stacked(tp, A, STEPS, rng, frame0=frame0, device=CPU)
        out += tbench._per_step(tree.map_leaves(
            lambda v: v.to(dtype) if v.is_floating_point() else v, x))
    return out


def _meas(tp, x):
    return (*x[:5], tpipe.FrameMeasurement.from_matches(tp.cfg, x[5]))


def _small_params(dtype="float64"):
    return configs.flagship_params(small=True)._replace(dtype=dtype)


def _tracker_setup(n_frames=3):
    """Frames of 2 agents at 120x160 (the reference's numpy renderer) and a
    24-slot tracker that detects on frame 0 and keeps on frame 1."""
    from torch_helpers import orbit_frames

    frames, imu = orbit_frames(A, n_frames, H, W)
    tp = configs.flagship_tracker(24)._replace(n_feat_min=20)
    return frames, imu, tp, configs.flagship_camera(H, W)


# ---------------------------------------------------------------------------
# (a) the capture-safety witness
# ---------------------------------------------------------------------------


def test_witness_finds_what_breaks_a_capture():
    x = torch.arange(6.0)
    for bad in (lambda: x.sum().item(), lambda: bool(x.any()), lambda: x[x > 2],
                lambda: torch.nonzero(x), lambda: torch.linalg.cholesky(torch.eye(3)),
                lambda: torch.cholesky_solve(torch.ones(2, 3, 1), torch.eye(3).expand(2, 3, 3)),
                lambda: torch.tensor([1.0, 2.0]) + x[:2], lambda: torch.as_tensor(3, device=CPU),
                lambda: x.clone().index_put_((torch.arange(2),), torch.tensor(1.0)),
                lambda: x.clone().__setitem__(torch.arange(2), 1.0)):
        with CaptureWitness() as w:
            bad()
        assert w.found, bad
    with CaptureWitness() as w:  # what a graph holds
        y = torch.where(x > 2, x, 0.0) * 2.0
        torch.linalg.cholesky_ex(torch.eye(3))
        torch.as_tensor(y)
        z = torch.zeros(3)
        z[1:] = 1.0
    w.assert_clean()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_filter_step_is_capture_safe(dtype):
    """The compiled filter step's call after its first (which fills the
    constant and counter caches) is free of capture-unsafe operations."""
    tp = _small_params(dtype)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    fs, slots = tvio.init_at_time(tp, 0.0, A, CPU, v=np.asarray(tbench.SIM_V0))
    step = tmesh.agent_step_fn(tp)
    xs = _match_windows(tp, tdt)
    fs, slots, _ = step(fs, slots, *_meas(tp, xs[0]))
    for x in xs[1:3]:
        meas_x = _meas(tp, x)
        with CaptureWitness() as w:
            fs, slots, applied = step(fs, slots, *meas_x)
        w.assert_clean()
    assert bool(applied.all())


def test_tracker_segments_are_capture_safe():
    """The tracker's three graph segments, on a detection frame and on a
    keep frame (each frame runs both branches under the witness), after a
    first frame."""
    frames, _, tp, cam = _tracker_setup()
    state = ttrk.TrackerState.zero(tp, A, H, W, dtype=torch.float64, device=CPU)
    gates = []
    for k in range(3):
        imgs = torch.from_numpy(frames[k])
        with CaptureWitness() as w:
            out = ttrk._track_segment(tp, cam, state, imgs, None, 0)
            _, tracked, cur_pts, pyr, need, _ = out
            detected = ttrk._detect_segment(tp, state, imgs, tracked, cur_pts, pyr, need)
            kept = ttrk._keep_segment(state, imgs, tracked, cur_pts)
            bufs = graph.stage(state)
            graph.write_carry(bufs, detected, "tracker")
            graph.write_carry(bufs, kept, "tracker")
        if k:
            w.assert_clean()
        gates.append(bool(out[-1]))
        state = detected if gates[-1] else kept
    assert gates[0] and not gates[1], gates


# ---------------------------------------------------------------------------
# (b), (c) the compiled programs against the reference's jitted ones
# ---------------------------------------------------------------------------


def test_compiled_filter_step_matches_jax_agent_step():
    """4 steps at A = 2 of ``mesh.agent_step_fn`` (compiled; its plain path
    on the CPU) against the reference's jitted ``mesh.agent_step_fn`` on the
    same numpy-seeded inputs, float64: integer and boolean leaves exactly,
    float leaves to 1e-9 of each leaf's max."""
    import jax
    import jax.numpy as jnp

    import bench
    import __graft_entry__ as ge
    from torch_helpers import assert_tree_close, np_tree, stack
    from x_multi_agent_tpu.parallel import mesh as jmesh
    from x_multi_agent_tpu.vio import pipeline as jpipe
    from x_multi_agent_tpu.vio import vio as jvio

    jp = ge._params(small=True)._replace(dtype="float64")
    tp = _small_params()
    fs, slots = jvio.init_at_time(jp, 0.0, v=np.asarray(bench.SIM_V0))
    fs, slots = stack(fs, A), stack(slots, A)
    p_fs, p_slots = tvio.init_at_time(tp, 0.0, A, CPU, v=np.asarray(tbench.SIM_V0))
    ref_step = jax.jit(jmesh.agent_step_fn(jp))
    ref_meas = jax.vmap(lambda m: jpipe.FrameMeasurement.from_matches(jp.cfg, m))
    step = tmesh.agent_step_fn(tp)
    ref_in = bench._match_inputs_stacked(jp, A, STEPS, np.random.default_rng(0))
    ref_in = jax.tree.map(lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating)
                          else x, ref_in)
    got_in = _match_windows(tp)[:STEPS]
    for k in range(STEPS):
        r = jax.tree.map(lambda x: x[k], ref_in)
        fs, slots, app = ref_step(fs, slots, *r[:5], ref_meas(r[5]))
        p_fs, p_slots, p_app = step(p_fs, p_slots, *_meas(tp, got_in[k]))
        np.testing.assert_array_equal(p_app.numpy(), np.asarray(app))
        assert_tree_close(p_slots, np_tree(slots), 1e-9, "slots")
        assert_tree_close(p_fs, np_tree(fs), 1e-9, "filter")
    assert bool(p_app.all()) and step.captures == 1


def test_track_frame_batch_jit_matches_jax():
    """``track_frame_batch_jit`` against the reference's on a detection
    frame, then keep frames, with the reference's RANSAC draws: ids, levels
    and masks exactly, points to 1e-8 px and matches to 1e-8 (the tolerances
    of the eager tracker's test)."""
    import jax.numpy as jnp

    from torch_helpers import assert_tree_close, jax_frame_indices, np_tree, stack, t, to_port
    from x_multi_agent_tpu.vision import camera as jcam
    from x_multi_agent_tpu.vision import tracker as jtrk

    frames, _, tp, cam = _tracker_setup()
    jp = jtrk.TrackerParams(**tp._asdict())
    jc = jcam.Camera(*cam)
    jstate = stack(jtrk.TrackerState.zero(jp, H, W, jnp.float64), A)
    tstate = to_port(jstate)
    kept = []
    for k in range(3):
        imgs = jnp.asarray(frames[k])
        idx = jax_frame_indices(jp, jstate, imgs)
        before = int(np.asarray(jstate.next_id).sum())
        jstate, jm = jtrk.track_frame_batch_jit(jp, jc, jstate, imgs)
        kept.append(int(np.asarray(jstate.next_id).sum()) == before)
        tstate, tm_ = ttrk.track_frame_batch_jit(tp, cam, tstate, t(frames[k]), ransac_idx=t(idx))
        assert_tree_close(tstate, np_tree(jstate), 1e-8 / (W + H), "tracker")
        assert_tree_close(tm_, np_tree(jm), 1e-8, "matches")
    assert kept == [False, True, True] and int(np.asarray(jm.valid).sum()) > 10


def test_compiled_frame_step_equals_eager_on_the_cpu():
    """``CompiledFrameStep`` against ``frame_step`` over 3 frames (keyed
    RANSAC draws, float32): every leaf and ``applied`` bit for bit."""
    frames, imu, tp, cam = _tracker_setup()
    params = configs.flagship_params(small=True)
    f32 = [torch.from_numpy(np.asarray(v, np.float32 if v.dtype.kind == "f" else v.dtype))
           for v in imu]
    runs = []
    for step in (None, CompiledFrameStep(params, tp, cam)):
        fs, slots = tvio.init_at_time(params, 0.0, A, CPU)
        tstate = ttrk.TrackerState.zero(tp, A, H, W, device=CPU)
        out = []
        for k in range(3):
            x = [v[k] for v in f32]
            imgs = torch.from_numpy(frames[k].astype(np.float32))
            if step is None:
                tstate, fs, slots, _, app = frame_step(params, tp, cam, tstate, fs, slots, imgs,
                                                       *x, x[0][:, -1])
            else:
                tstate, fs, slots, _, app = step(tstate, fs, slots, imgs, *x, x[0][:, -1])
            out.append([v.clone() for v in tree.leaves((tstate, fs, slots, app))])
        runs.append(out)
    for got, ref in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ---------------------------------------------------------------------------
# (d) the wrapper's carry rule and capture keys
# ---------------------------------------------------------------------------


class _Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


@dataclasses.dataclass(frozen=True)
class _State:
    x: torch.Tensor
    pair: _Pair
    k: int  # a Python leaf: part of the capture key


def _toy(state: _State, inp: torch.Tensor):
    # b <- a and a <- b + inp: each carried result reads the other's buffer
    return (_State(x=state.x * 2.0, pair=_Pair(a=state.pair.b + inp, b=state.pair.a), k=state.k),
            state.x.sum(-1))


def _toy_state(n=3, k=0):
    return _State(x=torch.arange(float(n)), pair=_Pair(torch.ones(n), torch.zeros(n)), k=k)


class _Copies(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func._schema.name.split("::")[-1] == "copy_"
        return func(*args, **(kwargs or {}))


def test_carry_buffers_passed_back_are_not_copied():
    prog = graph.compiled(_toy, "toy", n_carry=1)
    s0 = _toy_state()
    s1, total = prog(s0, torch.full((3,), 5.0))
    assert float(total) == 3.0 and s0.x.tolist() == [0.0, 1.0, 2.0]  # s0 is not a buffer
    with _Copies() as c:
        graph.copy_in((s1, torch.zeros(3)), (s1, torch.zeros(3)))
    assert c.n == 1  # the per-step input only
    s2, _ = prog(s1, torch.full((3,), 1.0))
    assert all(a is b for a, b in zip(tree.leaves(s2), tree.leaves(s1)))  # the same buffers
    assert s2.x.tolist() == [0.0, 4.0, 8.0]
    # a <- b + 1 = 2; b <- the old a = 5 (read before a's buffer was written)
    assert s2.pair.a.tolist() == [2.0] * 3 and s2.pair.b.tolist() == [5.0] * 3
    assert prog.captures == 1


def test_fresh_tree_is_copied_in():
    prog = graph.compiled(_toy, "toy", n_carry=1)
    s1, _ = prog(_toy_state(), torch.zeros(3))
    fresh = _toy_state()
    s2, total = prog(fresh, torch.zeros(3))
    assert s2.x is s1.x and s2.x.tolist() == [0.0, 2.0, 4.0] and float(total) == 3.0
    fresh.x.add_(100.0)  # the caller's tree is not the program's buffer
    assert s2.x.tolist() == [0.0, 2.0, 4.0] and prog.captures == 1


def test_new_shape_or_static_argument_captures_anew():
    prog = graph.compiled(_toy, "toy", n_carry=1)
    prog(_toy_state(), torch.zeros(3))
    prog(_toy_state(4), torch.zeros(4))
    assert prog.captures == 2
    prog(_toy_state(k=1), torch.zeros(3))
    assert prog.captures == 3
    prog(_toy_state(), torch.zeros(3))
    prog(_toy_state(3, k=1), torch.zeros(3))
    assert prog.captures == 3
    prog(_toy_state(), torch.zeros(1))
    assert prog.captures == 4  # another shape of a per-step input


def test_carried_results_must_match_the_carried_arguments():
    prog = graph.compiled(lambda s: (s.double(),), "widen", n_carry=1)
    with pytest.raises(ValueError, match="widen"):
        prog(torch.zeros(2))


def test_shared_carry_passes_state_between_programs_without_copies():
    """Two programs on one ``Carry``: what one returns is the buffer the
    other reads and writes, passed back with no copy; a fresh tree is
    copied into it."""
    carry = graph.Carry()
    double = graph.compiled(lambda s, x: (s * 2.0 + x,), "double", 1, carry)
    add = graph.compiled(lambda s, x: (s + x, s.sum()), "add", 1, carry)
    s, = double(torch.ones(3), torch.zeros(3))
    s2, total = add(s, torch.full((3,), 1.0))
    assert s2 is s and s.tolist() == [3.0] * 3 and float(total) == 6.0
    with _Copies() as c:
        s3, = double(s2, torch.zeros(3))
    assert s3 is s and s.tolist() == [6.0] * 3 and c.n == 2  # the input and the carry write
    with _Copies() as c:
        s4, = double(torch.zeros(3), torch.ones(3))  # a fresh tree: copied in as well
    assert s4 is s and s.tolist() == [1.0] * 3 and c.n == 3
    assert double.captures == add.captures == 1


def test_shared_carry_rejects_two_carried_arguments_of_one_spec():
    prog = graph.compiled(lambda a, b: (b, a), "swap", 2, graph.Carry())
    with pytest.raises(ValueError, match="swap"):
        prog(torch.zeros(2), torch.ones(2))
    assert graph.compiled(lambda a, b: (b, a), "swap", 2)(torch.zeros(2), torch.ones(2))[0].tolist() == [1.0] * 2


def test_static_values_key_the_capture():
    """A call's ``static`` values (what the function reads from its closure)
    are part of its capture key."""
    scale = {"k": 2.0}
    prog = graph.compiled(lambda s: (s * scale["k"],), "scaled", 1)
    s, = prog(torch.ones(2), static=(2.0,))
    s, = prog(s, static=(2.0,))
    assert prog.captures == 1 and s.tolist() == [4.0] * 2
    scale["k"] = 3.0
    s, = prog(s, static=(3.0,))
    assert prog.captures == 2 and s.tolist() == [12.0] * 2


# ---------------------------------------------------------------------------
# (e) on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.gpu
def test_compiled_filter_step_equals_eager_bit_for_bit(cuda):
    tp = configs.flagship_params(small=True)
    xs = [tree.map_leaves(lambda v: v.to(cuda), _meas(tp, x))
          for x in _match_windows(tp, torch.float32)[:5]]
    eager, comp = tmesh.agent_step(tp), tmesh.agent_step_fn(tp)
    e_fs, e_slots = tvio.init_at_time(tp, 0.0, A, cuda, v=np.asarray(tbench.SIM_V0))
    c_fs, c_slots = tvio.init_at_time(tp, 0.0, A, cuda, v=np.asarray(tbench.SIM_V0))
    for x in xs:
        e_fs, e_slots, e_app = eager(e_fs, e_slots, *x)
        c_fs, c_slots, c_app = comp(c_fs, c_slots, *x)
        for a, b in zip(tree.leaves((e_fs, e_slots, e_app)), tree.leaves((c_fs, c_slots, c_app))):
            assert torch.equal(_bits(a), _bits(b))
    assert comp.graphs.captured == 1


@pytest.mark.gpu
@pytest.mark.parametrize("agents", [512, 1])
def test_compiled_filter_step_equals_eager_at_the_bench_fleets(cuda, agents):
    """The flagship filter step at the matches cells' fleets (512 agents,
    and 1) on the bench's match inputs from its start: the compiled step
    (one graph, captured on the first step) and the eager one from one
    start, every leaf bit for bit after each of 8 steps, every covariance
    finite, the last step's update applied on at least 95 % of the
    agents."""
    params = configs.flagship_params()
    xs = tbench._per_step(tbench.match_inputs_stacked(params, agents, 8, np.random.default_rng(0),
                                                      device=cuda))
    comp = tmesh.agent_step_fn(params)
    steps = [tbench.filter_step(params, s) for s in (tmesh.agent_step(params), comp)]
    states = [tvio.init_at_time(params, 0.0, agents, cuda, v=np.asarray(tbench.SIM_V0))
              for _ in steps]
    for x in xs:
        outs = [step(*st, *x) for step, st in zip(steps, states)]
        for a, b in zip(*(tree.leaves(o) for o in outs)):
            assert torch.equal(_bits(a), _bits(b))
        states = [o[:2] for o in outs]
    assert comp.graphs.captured == 1
    assert all(bool(torch.isfinite(st[0].cov).all()) for st in states)
    assert int(outs[1][2].sum()) >= 0.95 * agents


@pytest.mark.gpu
def test_compiled_frame_step_equals_eager_bit_for_bit(cuda):
    """At the image bench's size (64 agents at rest at the origin, 480x640
    orbit frames, the flagship dims) over 8 frames: ``CompiledFrameStep``
    first captures its detection graph on frame 0 and its keep graph on
    frame 1; then it and ``frame_step`` run from one start in turns. Every
    leaf bit for bit after every frame, K1 and K2 launched alike (K1 at
    least once, from a replayed graph), nothing captured after the first
    two frames, every covariance finite."""
    agents, h, w, n = 64, 480, 640, 8
    params = configs.flagship_params()
    tp = configs.flagship_tracker(params.cfg.tracks.n_matches)
    cam = configs.flagship_camera(h, w)
    frames, imu = tbench.orbit_frames(agents, n, h, w, cuda)
    imu = [x.to(params.tdtype) if x.is_floating_point() else x for x in imu]
    xs = [(frames[k], *(x[k] for x in imu)) for k in range(n)]
    start = (ttrk.TrackerState.zero(tp, agents, h, w, device=cuda),
             *tvio.init_at_time(params, 0.0, agents, cuda))
    comp = CompiledFrameStep(params, tp, cam)
    state = start
    for x in xs[:2]:
        state = comp(*state, *x)[:3]
    primed = sum(g.captured for g in comp.graphs)
    runs = {"eager": lambda st, x: frame_step(params, tp, cam, *st, *x),
            "compiled": lambda st, x: comp(*st, *x)}
    states = dict.fromkeys(runs, start)
    k1_compiled = 0
    for k, x in enumerate(xs):
        out = {}
        for mode, run in runs.items():
            k1, k2 = fast.K1.launches, lk.K2.launches
            tstate, fs, slots, _, applied = run(states[mode], x)
            states[mode] = (tstate, fs, slots)
            out[mode] = (tree.leaves((tstate, fs, slots, applied)),
                         (fast.K1.launches - k1, lk.K2.launches - k2))
        (got, n_got), (ref, n_ref) = out["compiled"], out["eager"]
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, ref)), k
        assert n_got == n_ref and n_got[1] >= 3, (k, n_got, n_ref)
        k1_compiled += n_got[0]
    assert k1_compiled >= 1
    assert sum(g.captured for g in comp.graphs) == primed
    assert all(g.kernels_read for g in comp.graphs)
    assert all(bool(torch.isfinite(st[1].cov).all()) for st in states.values())


@pytest.mark.gpu
def test_track_rows_counts_advance_on_replay(cuda):
    """The filter step's three row builders go through the track-rows
    kernel: its launches rise by 3 (each with its finiteness pass over P,
    and 8 launches of the window tracks' reflections) on the eager first
    call and on every replay of the captured graph, read from the graph's
    kernel nodes."""
    from x_multi_agent_torch.vio.updates import track_rows

    tp = configs.flagship_params(small=True)._replace(dtype="float32")
    xs = [tree.map_leaves(lambda v: v.to(cuda), _meas(tp, x))
          for x in _match_windows(tp, torch.float32)[:4]]
    comp = tmesh.agent_step_fn(tp)
    fs, slots = tvio.init_at_time(tp, 0.0, A, cuda, v=np.asarray(tbench.SIM_V0))
    counts = []
    kernels = (track_rows.TRACK_ROWS, track_rows.COV_FINITE, track_rows.REFLECT)
    for x in xs:
        before = [k.launches for k in kernels]
        fs, slots, _ = comp(fs, slots, *x)
        counts.append(tuple(k.launches - b for k, b in zip(kernels, before)))
    assert counts == [(3, 3, 8)] * len(xs) and comp.graphs.captured == 1
    assert comp.graphs.kernels_read


@pytest.mark.gpu
def test_capture_failure_raises_with_no_eager_fallback(cuda):
    prog = graph.compiled(lambda s: (s + s.sum().item(),), "reads_the_host", n_carry=1)
    with pytest.raises(RuntimeError, match="reads_the_host"):
        prog(torch.ones(4, device=cuda))
    with pytest.raises(RuntimeError, match="reads_the_host"):  # not swallowed on a later call
        prog(torch.ones(4, device=cuda))


@pytest.mark.gpu
def test_kernel_counts_advance_on_replay(cuda):
    """K1 and K2 counted on every replay, from the graphs' kernel nodes read
    by function name, as the eager tracker counts them at launch, with the
    same state after each frame."""
    frames, _, tp, cam = _tracker_setup(4)
    prog = ttrk.TrackerProgram(tp, cam)
    states = [ttrk.TrackerState.zero(tp, A, H, W, device=cuda) for _ in range(2)]
    counts = []
    for k in range(4):
        imgs = torch.from_numpy(frames[k].astype(np.float32)).to(cuda)
        n = []
        for i, run in enumerate((lambda s: ttrk.track_frame_batch(tp, cam, s, imgs),
                                 lambda s: prog(s, imgs))):
            k1, k2 = fast.K1.launches, lk.K2.launches
            states[i], _ = run(states[i])
            n.append((fast.K1.launches - k1, lk.K2.launches - k2))
        counts.append(n)
        for a, b in zip(tree.leaves(states[0]), tree.leaves(states[1])):
            assert torch.equal(_bits(a), _bits(b))
    assert all(e == c for e, c in counts) and counts[0][0][0] >= 1
    assert all(c[1][1] >= 3 for c in counts) and prog.graphs.captured >= 2
    assert prog.graphs.kernels_read


@pytest.mark.gpu
def test_program_dropped_in_a_cycle_does_not_break_a_capture(cuda):
    """A program dropped in a reference cycle (a program's graphs refer to
    it) is freed by the collector; with the collector running at every
    allocation, a later capture must still succeed."""
    import gc

    old = graph.compiled(lambda s: (s * 2.0,), "old", n_carry=1)
    s, = old(torch.ones(4, device=cuda))
    s, = old(s)
    old.self_ref = old
    del old
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        new = graph.compiled(lambda s: (s + 1.0,), "new", n_carry=1)
        s, = new(torch.ones(4, device=cuda))
        s, = new(s)
    finally:
        gc.set_threshold(*threshold)
    assert s.tolist() == [3.0] * 4 and new.graphs.captured == 1
