"""PyTorch port: the ``VIO`` facade's compiled programs and the compiled
full-map round (``vio/vio.py``, ``parallel/collab.py``, ``utils/graph.py``).

The facade runs its per-frame calls as programs it owns, sharing its state
as one carry; on the CPU each runs its plain path (the function on the
staged buffers, no graph). These tests hold:

* capture safety: every program's body after its first call per capture
  key (which fills the constant caches) under ``CaptureWitness``, in float64
  and float32: the IMU sample and batch, the match, debug and collaborative
  updates, the peer receive, the photometric frame (with the correction)
  and spatial solve, the full-map round, and the range and sun rows;
* the compiled facade against the reference's jitted one in float64 on a
  match-driven run (IMU windows of several lengths, range and sun rows,
  debug on; one capture per window length), and the compiled full-map round
  against ``collaborative_round_jit`` (the photometric facade and the
  collaborating pair: ``test_torch_photometric.py`` and
  ``test_torch_request_comm.py``, whose facades are compiled by default);
* the buffers' rules: two facades interleaved equal each run alone, the
  debug payload survives a dropped update, an ATE-report snapshot survives
  later frames;
* on a card (``gpu``-marked, skipped here): each compiled facade path and
  the compiled round against the eager twin (``compiled=False``), every
  leaf bit for bit after every frame.

JAX is imported inside the tests that compare with it, so the card's
machine runs the ``gpu`` tests with ``python -m pytest --noconftest -m gpu
tests/test_torch_facade_graph.py``.
"""
import contextlib

import numpy as np
import pytest
import torch

from test_torch_graph import CaptureWitness
from x_multi_agent_torch import configs
from x_multi_agent_torch.parallel import collab
from x_multi_agent_torch.utils import ate_report, graph, tree
from x_multi_agent_torch.utils.bench import orbit_frames
from x_multi_agent_torch.vio import track_manager as tm
from x_multi_agent_torch.vio import vio as tvio
from x_multi_agent_torch.vio.range_facet import feature_triangle_at_point
from x_multi_agent_torch.vio.updates import solar

CPU = torch.device("cpu")
H, W, N_WORDS = 120, 160, 16


def _params(dtype="float64", aux=False):
    p = configs.flagship_params(small=True)._replace(dtype=dtype)
    if aux:
        p = p._replace(cfg=p.cfg._replace(enable_range=True, enable_sun=True))
    return p


def _tracker(descriptors=False):
    return configs.flagship_tracker(24)._replace(n_feat_min=20, compute_descriptors=descriptors)


def _words(device):
    g = torch.Generator().manual_seed(3)
    return torch.randint(0, 256, (N_WORDS, 32), generator=g, dtype=torch.uint8).to(device)


def _image_facade(params, uav, device, compiled=True, photometric=None, words=None, debug=False):
    """A facade on agent ``uav``'s orbit at ``H`` x ``W``, at rest at the
    origin; ``photometric``: ``enable_photometric``'s keywords; ``words``:
    collaboration on, with tracker descriptors."""
    v = tvio.VIO(params, device=device, compiled=compiled, debug=debug)
    v.init_at_time(0.0)
    v.setup_tracker(_tracker(words is not None), configs.flagship_camera(H, W), H, W, seed=uav)
    v.enable_health_monitor(min_matches=4)
    if photometric is not None:
        v.enable_photometric(**photometric)
    if words is not None:
        v.enable_collab(words, uav_id=uav, seed=10 + uav)
    return v


def _image_frame(v, frames, imu, k, uav):
    times, seqs, ws, accs = (x[k][uav] for x in imu[:4])
    v.process_imu_batch(times.cpu().numpy(), seqs.cpu().numpy(), ws.cpu().numpy(),
                        accs.cpu().numpy())
    return v.process_image_measurement(float(times[-1]), k, frames[k][uav])


def _exchange(vs):
    """Each facade receives the other's full payload."""
    for req in range(len(vs)):
        res = 1 - req
        vs[req].process_other_measurements(vs[res].get_data_to_send(), uav_id=res)


def _circle_sim(duration, seed=2):
    from x_multi_agent_torch.utils.sim import make_circle_sim

    return make_circle_sim(duration=duration, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                           match_budget=24, pixel_noise=5e-4, seed=seed)


def _sim_matches(sim, f, dtype, device):
    def b(x):
        return torch.as_tensor(np.asarray(x), device=device)[None]

    return tm.Matches.of(track_id=b(sim.match_id[f]).to(torch.int32),
                         prev_pt=b(sim.match_prev[f]).to(dtype),
                         cur_pt=b(sim.match_cur[f]).to(dtype), valid=b(sim.match_valid[f]))


def _match_frames(v, sim, frames, aux=False, batch_every=2):
    """Drive ``v`` over ``frames`` of a circle simulation: per-sample IMU on
    every ``batch_every``-th frame, windows otherwise (their length varies
    with the frame), the range and sun rows every third frame with ``aux``.
    Yields (frame, applied)."""
    imu_i = 0
    for f, t_cam in enumerate(sim.cam_t):
        lo = imu_i
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
            imu_i += 1
        if f not in frames:
            continue
        if f % batch_every == 0:
            for i in range(lo, imu_i):
                v.process_imu(sim.imu_t[i], i, sim.imu_w[i], sim.imu_a[i])
        else:
            sl = slice(lo, imu_i)
            v.process_imu_batch(sim.imu_t[sl], np.arange(lo, imu_i), sim.imu_w[sl], sim.imu_a[sl])
        if aux and f % 3 == 2:
            v.set_last_range_measurement(7.0, np.array([0.01, -0.02]))
            v.set_last_sun_angle_measurement(30.0, -20.0)
        yield f, v.process_matches_measurement(t_cam, f, _sim_matches(sim, f, v.params.tdtype,
                                                                        v.device))


def _leaves(*objs):
    return [x.clone() for x in tree.leaves(objs) if isinstance(x, torch.Tensor)]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _facade_state(v):
    return _leaves(v.fs, v.slots, getattr(v, "_tracker_state", None), v.photo,
                   getattr(v, "_store", None), getattr(v, "_db", None),
                   getattr(v, "_kf_meta", None))


# ---------------------------------------------------------------------------
# (a) capture safety of every program
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _witnessing(found: dict):
    """Run every compiled program's body after its first call per capture
    key under a ``CaptureWitness``; ``found[name]`` lists what the witness
    found in program ``name`` (empty: witnessed and clean)."""
    body, seen = graph.Compiled._body, set()

    def watched(self, bufs):
        key = (id(self), id(bufs))
        if key not in seen:
            seen.add(key)
            return body(self, bufs)
        with CaptureWitness() as w:
            out = body(self, bufs)
        found.setdefault(self.name, []).extend(w.found)
        return out

    graph.Compiled._body = watched
    try:
        yield
    finally:
        graph.Compiled._body = body


_WITNESS = {}


def _witnessed(dtype: str) -> dict:
    """Every facade program driven on the CPU in ``dtype`` under
    :func:`_witnessing`: a match-driven facade with range and sun rows, one
    with debug on, a collaborating pair of image facades with the spatial
    photometric calibration (solved every frame once the ring holds 20 rows)
    exchanging full payloads
    every frame, the compiled full-map round on the pair twice; and the
    range facet and sun rows called directly."""
    if dtype in _WITNESS:
        return _WITNESS[dtype]
    found = {}
    with _witnessing(found):
        sim = _circle_sim(0.8)
        for aux, debug in ((True, False), (False, True)):
            v = tvio.VIO(_params(dtype, aux), device=CPU, debug=debug)
            v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
            list(_match_frames(v, sim, range(8), aux=aux))
        frames, imu = orbit_frames(2, 5, H, W, CPU)
        frames = frames.to(getattr(torch, dtype))
        photo = dict(n_obs=16, spatial=True, cell_px=20, spatial_every=1)
        words = _words(CPU)
        vs = [_image_facade(_params(dtype), u, CPU, photometric=photo, words=words)
              for u in range(2)]
        for k in range(5):
            for u, v in enumerate(vs):
                _image_frame(v, frames, imu, k, u)
            _exchange(vs)
        round_fn = collab.collaborative_round_fn(vs[0].params, collab.CollabConfig())
        fs = tree.cat([vs[0].fs, vs[1].fs])
        for _ in range(2):
            fs, _ = round_fn(fs)
    rows = []
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    pts, query = torch.rand((2, 6, 2), generator=g, dtype=dt), torch.rand((2, 2), generator=g, dtype=dt)
    q = torch.nn.functional.normalize(torch.rand((2, 4), generator=g, dtype=dt), dim=-1)
    cov = torch.eye(12, dtype=dt).expand(2, 12, 12)
    for k in range(2):
        with CaptureWitness() as w:
            feature_triangle_at_point(pts, torch.ones((2, 6), dtype=torch.bool), query)
            solar.build(torch.full((2, 2), 10.0, dtype=dt), q, cov, torch.ones(2, dtype=torch.bool))
        if k:
            rows = w.found
    found["rows"] = rows
    _WITNESS[dtype] = found
    return found


_PROGRAMS = {
    "process_imu": ("VIO.process_imu",),
    "process_imu_batch": ("VIO.process_imu_batch",),
    "process_matches": ("VIO.process_matches",),  # with the range and sun rows active
    "process_matches_debug": ("VIO.process_matches_debug",),
    "process_matches_collab": ("VIO.process_matches_collab",),
    "receive_and_record": ("VIO.receive_and_record",),
    "photo_frame": ("VIO.photo_correct", "VIO.photo_frame"),
    "spatial_solve": ("VIO.spatial_solve",),
    "collaborative_round": ("collaborative_round",),
    "rows": ("rows",),
}


@pytest.mark.parametrize("program", list(_PROGRAMS))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_facade_programs_are_capture_safe(program, dtype):
    """Each program, witnessed on a call after its first, is free of
    capture-unsafe operations (a host read, a tensor from host data, a
    data-dependent shape, a host-checked or MAGMA-routed solve)."""
    found = _witnessed(dtype)
    for name in _PROGRAMS[program]:
        assert name in found, f"{name} was never witnessed"
        assert not found[name], "capture-unsafe operations in " + name + ":\n" + "\n".join(
            f"== {what}\n{where}" for what, where in found[name])


# ---------------------------------------------------------------------------
# (b) the compiled facade and round against the reference's jitted ones
# ---------------------------------------------------------------------------


def test_compiled_match_facade_matches_jax():
    """A match-driven run through the compiled facade (per-sample IMU and
    windows of several lengths, the range and sun rows, debug on) and the
    reference's facade in float64, frame by frame: ``applied``, tail and
    anchor states, the debug payload; the filter and the slots at the end
    (integers and booleans exactly); one capture per IMU window length."""
    import jax.numpy as jnp

    from test_collab import PARAMS
    from torch_helpers import assert_tree_close, np_tree, port_params, stack
    from x_multi_agent_tpu.utils.sim import make_circle_sim
    from x_multi_agent_tpu.vio import track_manager as jtm
    from x_multi_agent_tpu.vio import vio as jvio

    jp = PARAMS._replace(cfg=PARAMS.cfg._replace(enable_range=True, enable_sun=True))
    sim = make_circle_sim(duration=1.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
                          match_budget=jp.cfg.tracks.n_matches, pixel_noise=5e-4, seed=3)
    jv, tv = jvio.VIO(jp, debug=True), tvio.VIO(port_params(jp), debug=True, device=CPU)
    for v in (jv, tv):
        v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
    lengths, imu_i = set(), 0
    for f, t_cam in enumerate(sim.cam_t):
        lo = imu_i
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
            imu_i += 1
        n = imu_i - lo - (f % 3)  # windows of several lengths, the rest one by one
        sl = slice(lo, lo + n)
        args = (sim.imu_t[sl], np.arange(lo, lo + n), sim.imu_w[sl], sim.imu_a[sl])
        jv.process_imu_batch(*args)
        tv.process_imu_batch(*args)
        lengths.add(n)
        for i in range(lo + n, imu_i):
            for v in (jv, tv):
                v.process_imu(sim.imu_t[i], i, sim.imu_w[i], sim.imu_a[i])
        if f % 3 == 2:
            for v in (jv, tv):
                v.set_last_range_measurement(7.0, np.array([0.01, -0.02]))
                v.set_last_sun_angle_measurement(30.0, -20.0)
        jm = jtm.Matches.of(
            track_id=jnp.asarray(sim.match_id[f]), prev_pt=jnp.asarray(sim.match_prev[f]),
            cur_pt=jnp.asarray(sim.match_cur[f]), valid=jnp.asarray(sim.match_valid[f]),
        )
        ja = jv.process_matches_measurement(t_cam, f, jm)
        ta = tv.process_matches_measurement(t_cam, f, _sim_matches(sim, f, torch.float64, CPU))
        assert ja == ta, f
        assert_tree_close(tv.tail_state(), np_tree(stack(jv.tail_state(), 1)), 1e-9, f"tail[{f}]",
                          floor=1.0)
        assert_tree_close(tv.anchor_state(), np_tree(stack(jv.anchor_state(), 1)), 1e-9,
                          f"anchor[{f}]", floor=1.0)
        if jv.last_debug is not None:
            assert_tree_close(tv.last_debug, np_tree(stack(jv.last_debug, 1)), 1e-9, f"debug[{f}]")
    assert_tree_close(tv.fs, np_tree(stack(jv.fs, 1)), 1e-8, "fs")
    assert_tree_close(tv.slots, np_tree(stack(jv.slots, 1)), 1e-8, "slots")
    progs = {p.name: p for p in tv.programs}
    assert progs["VIO.process_imu_batch"].captures == len(lengths) > 1
    assert progs["VIO.process_imu"].captures == progs["VIO.process_matches_debug"].captures == 1
    assert ta and len(tv.get_slam_features_cartesian()) > 0


def test_compiled_round_matches_collaborative_round_jit():
    """The compiled full-map round (twice from the same start: its second
    call copies a fresh state into its buffers) against the reference's
    ``collaborative_round_jit`` on two agents of a 1.5 s reference run."""
    import jax
    import jax.numpy as jnp

    from test_collab import CCFG, PARAMS, run_agent
    from torch_helpers import assert_tree_close, np_tree, port_params, to_port
    from x_multi_agent_tpu.parallel import collab as jcollab

    va, _ = run_agent((0.0, 0.0, 0.0), 1e-3, duration=1.5)
    vb, _ = run_agent((0.25, 0.0, 0.0), 0.5, duration=1.5)
    agents = jax.tree.map(lambda x, y: jnp.stack([x, y]), va.fs, vb.fs)
    ref_fs, ref_nm = jcollab.collaborative_round_jit(PARAMS, CCFG, agents)
    ccfg = collab.CollabConfig(**{f: getattr(CCFG, f) for f in collab.CollabConfig._fields})
    round_fn = collab.collaborative_round_fn(port_params(PARAMS), ccfg)
    for _ in range(2):
        got_fs, got_nm = round_fn(to_port(agents))
        np.testing.assert_array_equal(got_nm.numpy(), np.asarray(ref_nm))
        assert_tree_close(got_fs, np_tree(ref_fs), 1e-8, "fs")
    assert int(got_nm.sum()) > 0 and round_fn.captures == 1


# ---------------------------------------------------------------------------
# (c) the buffers' rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["match", "image"])
def test_interleaved_facades_equal_each_alone(path):
    """Two facades of equal shapes, their calls interleaved frame by frame,
    end where each run alone ends (every leaf equal): no program or buffer
    is shared between facades."""
    params = _params()
    if path == "match":
        sims = [_circle_sim(0.6, seed=s) for s in (2, 5)]

        def make(i):
            v = tvio.VIO(params, device=CPU)
            v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
            return v, iter(_match_frames(v, sims[i], range(6)))

        def step(run):
            next(run[1])
    else:
        frames, imu = orbit_frames(2, 4, H, W, CPU)
        frames = frames.double()
        photo = dict(n_obs=16, spatial=True, cell_px=20, spatial_every=2)

        def make(i):
            v = _image_facade(params, i, CPU, photometric=photo)
            return v, [i, 0]

        def step(run):
            i, k = run[1]
            _image_frame(run[0], frames, imu, k, i)
            run[1][1] += 1

    n = 6 if path == "match" else 4
    alone = []
    for i in range(2):
        run = make(i)
        for _ in range(n):
            step(run)
        alone.append(_facade_state(run[0]))
    runs = [make(i) for i in range(2)]
    for _ in range(n):
        for run in runs:
            step(run)
    for run, ref in zip(runs, alone):
        assert _equal(_facade_state(run[0]), ref)
    assert not _equal(alone[0][:5], alone[1][:5])  # two different runs


def test_debug_payload_survives_a_dropped_update():
    """The last applied update's debug payload is kept as it was through a
    dropped update (a measurement outside the window), not the program's
    output buffer, which that call overwrote; the next applied update
    replaces it."""
    sim = _circle_sim(0.8)
    v = tvio.VIO(_params(), device=CPU, debug=True)
    v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
    applied = dict(_match_frames(v, sim, range(6)))
    assert applied[5] and v.last_debug is not None
    kept = _leaves(v.last_debug)
    m = _sim_matches(sim, 6, torch.float64, CPU)
    assert not v.process_matches_measurement(100.0, 6, m)  # outside the window: dropped
    assert _equal(_leaves(v.last_debug), kept)
    assert dict(_match_frames(v, sim, range(6, 8)))[7]
    assert not _equal(_leaves(v.last_debug), kept)


def test_ate_report_snapshot_survives_later_frames():
    """``ate_report._agent_state`` copies the facade's states: a snapshot
    taken after frame 2 holds after two more frames, which change every
    state it holds."""
    frames, imu = orbit_frames(1, 4, H, W, CPU)
    frames = frames.double()
    v = _image_facade(_params(), 0, CPU, photometric=dict(n_obs=16), words=_words(CPU))
    for k in range(2):
        _image_frame(v, frames, imu, k, 0)
    snap = ate_report._agent_state(v, 2)
    kept = _leaves(snap)
    for k in range(2, 4):
        _image_frame(v, frames, imu, k, 0)
    assert _equal(_leaves(snap), kept)
    assert not _equal(_leaves(ate_report._agent_state(v, 2)), kept)


# ---------------------------------------------------------------------------
# (d) on the card: compiled against the eager twin, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _twins(make, step, n):
    """``make(compiled)`` -> facades; ``step(facades, k)`` drives frame
    ``k``. The compiled and the eager facades from one start, every leaf
    compared after every frame. Returns the compiled facades."""
    runs = {c: make(c) for c in (True, False)}
    for k in range(n):
        for c in (True, False):
            step(runs[c], k)
        for vc, ve in zip(runs[True], runs[False]):
            assert _equal(_facade_state(vc), _facade_state(ve)), k
    return runs[True]


def _facade_twins(path: str, device, n: int):
    """:func:`_twins` on one facade path in float32: ``match`` (the circle
    simulation, per-sample IMU and windows, the range and sun rows, debug
    on), ``image`` (orbit frames, the spatial photometric calibration) or
    ``pair`` (two such facades collaborating, exchanging full payloads every
    frame). Returns the compiled facades."""
    params = _params("float32", aux=path == "match")
    if path == "match":
        sim = _circle_sim(1.0)

        def make(compiled):
            v = tvio.VIO(params, device=device, compiled=compiled, debug=True)
            v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
            return [v]

        def step(vs, k):
            list(_match_frames(vs[0], sim, [k], aux=True))

        return _twins(make, step, n)
    frames, imu = orbit_frames(2, n, H, W, device)
    photo = dict(n_obs=16, spatial=True, cell_px=20, spatial_every=3)
    words = _words(device) if path == "pair" else None

    def make(compiled):
        return [_image_facade(params, u, device, compiled, photo, words)
                for u in range(1 if words is None else 2)]

    def step(vs, k):
        for u, v in enumerate(vs):
            _image_frame(v, frames, imu, k, u)
        if words is not None:
            _exchange(vs)

    return _twins(make, step, n)


@pytest.mark.parametrize("path", ["match", "image", "pair"])
def test_compiled_facades_equal_eager_on_the_cpu(path):
    """The compiled facade's plain path against its eager twin, every leaf
    after every frame (the tracker program against ``track_frame``)."""
    vs = _facade_twins(path, CPU, 6 if path == "match" else 4)
    assert all(p.captures >= 1 for v in vs for p in v.programs)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["match", "image", "pair"])
def test_compiled_facades_equal_eager_bit_for_bit(cuda, path):
    vs = _facade_twins(path, cuda, 10 if path == "match" else 8)
    assert all(p.graphs.captured >= 1 for v in vs for p in v.programs)


@pytest.mark.gpu
def test_compiled_round_equals_eager_bit_for_bit(cuda):
    frames, imu = orbit_frames(2, 6, H, W, cuda)
    vs = [_image_facade(_params("float32"), u, cuda) for u in range(2)]
    for k in range(6):
        for u, v in enumerate(vs):
            _image_frame(v, frames, imu, k, u)
    ccfg = collab.CollabConfig()
    round_fn = collab.collaborative_round_fn(vs[0].params, ccfg)
    fs = tree.cat([v.fs for v in vs])
    for _ in range(3):
        eager = collab.collaborative_round(vs[0].params, ccfg, fs)
        comp = round_fn(fs)
        assert _equal(_leaves(*comp), _leaves(*eager))
        fs = eager[0]
    assert round_fn.graphs.captured == 1
