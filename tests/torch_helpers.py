"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Both packages get the same inputs, made from a numpy seed, and are compared
leaf by leaf: JAX runs as the rest of the suite runs it (CPU, float64 under
``tests/conftest.py``), the port runs on CPU tensors in float64.
"""
import dataclasses
import faulthandler
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from x_multi_agent_tpu.utils import scene
from x_multi_agent_tpu.vision import image as jimg
from x_multi_agent_tpu.vision import lk as jlk
from x_multi_agent_tpu.vision import tracker as jtrk

from x_multi_agent_torch.ekf.propagator import ImuNoise
from x_multi_agent_torch.photometric import calib as tcalib
from x_multi_agent_torch.ekf.state import StateDims
from x_multi_agent_torch.utils.convert import from_numpy, to_numpy
from x_multi_agent_torch.vio import pipeline as tpipe
from x_multi_agent_torch.vio import track_manager as ttm
from x_multi_agent_torch.vio import vio as tvio

# tier-1 runs several xdist workers on a few cores: one thread per worker
torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


def np_tree(x):
    """JAX pytree -> the same structure with numpy leaves."""
    return jax.tree.map(np.asarray, x)


def stack(x, a: int):
    """Broadcast every leaf of a single-agent JAX pytree to A agents."""
    return jax.tree.map(lambda v: np.broadcast_to(np.asarray(v), (a,) + np.shape(v)), x)


def to_port(x, dtype=F64):
    """JAX state object (A-batched) -> the port's dataclass on the CPU."""
    return from_numpy(np_tree(x), CPU, dtype)


def port_params(jp) -> tvio.VioParams:
    """The reference's ``VioParams`` -> the port's, field by field."""
    c = jp.cfg
    cfg = tpipe.VioConfig(**{**c._asdict(), "dims": StateDims(*c.dims),
                             "tracks": ttm.TrackDims(*c.tracks)})
    return tvio.VioParams(**{**jp._asdict(), "cfg": cfg, "imu_noise": ImuNoise(*jp.imu_noise)})


def sim_matches(sim, f, dtype=F64):
    """Frame ``f`` of a ``make_circle_sim`` run as the port's Matches (A = 1)."""
    return ttm.Matches.of(
        track_id=t(sim.match_id[f])[None], prev_pt=t(sim.match_prev[f], dtype)[None],
        cur_pt=t(sim.match_cur[f], dtype)[None], valid=t(sim.match_valid[f])[None],
    )


def t(x, dtype=None):
    """numpy / JAX array -> CPU tensor (floats to ``dtype`` when given)."""
    out = torch.from_numpy(np.array(x, copy=True))
    return out.to(dtype) if dtype is not None and out.is_floating_point() else out


def assert_tree_close(got, ref, rel: float, path: str = "state", floor: float = 0.0):
    """Compare the port's state (dataclass / tensor / NamedTuple) with the
    reference's (numpy leaves) leaf by leaf: integer and boolean leaves
    exactly, float leaves with atol = rel * max(max|ref leaf|, floor)."""
    if isinstance(got, torch.Tensor):
        g, r = to_numpy(got), np.asarray(ref)
        assert g.shape == r.shape, f"{path}: shape {g.shape} != {r.shape}"
        if r.dtype.kind == "f":
            scale = max(float(np.max(np.abs(r))) if r.size else 0.0, floor)
            np.testing.assert_allclose(g, r, rtol=0, atol=rel * scale, err_msg=path)
        else:
            np.testing.assert_array_equal(g, r.astype(g.dtype), err_msg=path)
        return
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_tree_close(getattr(got, f.name), getattr(ref, f.name), rel,
                              f"{path}.{f.name}", floor)
        return
    if isinstance(got, tuple):
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_tree_close(g, r, rel, f"{path}[{i}]", floor)
        return
    raise TypeError(f"{path}: cannot compare {type(got).__name__}")


def orbit_frames(a, n, h, w, tex_size=512):
    """Frames (n, A, h, w) float64 of the textured wall along each agent's
    6-DoF orbit, and each frame's IMU window (times, seqs, w, a), each
    (n, A, 10, ...): the image benchmark's orbit and IMU slicing, rendered
    with the numpy renderer (coarser texels, so the small field of view
    stays on the texture)."""
    tex = scene.make_texture(0, size=tex_size)
    frames = np.zeros((n, a, h, w))
    trajs = []
    for i in range(a):
        tr = scene.orbit_traj(
            duration=(n + 1) / 20.0, imu_rate=200.0, cam_rate=20.0, radius=1.5, omega=0.6,
            phase=2.0 * np.pi * i / a, yaw_amp=0.15, pitch_amp=0.10, roll_amp=0.08,
            z_amp=0.3, seed=i,
        )
        trajs.append(tr)
        for k in range(n):
            frames[k, i] = scene.render_wall_frame(
                tex, tr["cam_p"][k], tr["cam_rot"][k], h, w, 0.8 * w, 0.8 * w, m_per_px=0.016
            )
    idx = np.arange(n)[:, None] * 10 + np.arange(1, 11)[None, :]  # (n, 10)
    times = np.stack([tr["imu_t"][idx] for tr in trajs], axis=1)
    seqs = np.broadcast_to(idx[:, None], times.shape).astype(np.int32)
    ws = np.stack([tr["imu_w"][idx] for tr in trajs], axis=1)
    accs = np.stack([tr["imu_a"][idx] for tr in trajs], axis=1)
    return frames, (times, seqs, ws, accs)


def jax_sample_indices(mask, next_id, n_hyp):
    """The reference's hypothesis draw (ransac.py:101-106, tracker.py:202)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), next_id)
    probs = mask.astype(jnp.float64)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return jax.random.categorical(key, jnp.log(jnp.maximum(probs, 1e-30)), shape=(n_hyp, 8))


def jax_keyed_sampler(n_hyp=200):
    """A sampler for the port's collaboration RANSAC gates that repeats the
    reference's draw (``ransac.py:101-106``) under its key
    fold_in(fold_in(PRNGKey(seed), float32 bits of t), k), per agent
    (``collab.py:184-193``, ``match_store.py:165-171``)."""

    def draw(mask, seed, tm, k):
        out = []
        for i in range(mask.shape[0]):
            key = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(seed),
                                   jnp.asarray(float(tm[i]), jnp.float32).view(jnp.int32)),
                jnp.asarray(int(k[i]), jnp.int32),
            )
            probs = jnp.asarray(mask[i].cpu().numpy()).astype(jnp.float64)
            probs = probs / jnp.maximum(probs.sum(), 1.0)
            out.append(np.asarray(jax.random.categorical(
                key, jnp.log(jnp.maximum(probs, 1e-30)), shape=(n_hyp, 8))))
        return torch.from_numpy(np.stack(out)).to(mask.device)

    return draw


def jax_gain_indices(key, valid, dtype=jnp.float64, n_hyp=32):
    """The reference's hypothesis draw of ``estimate_gains_ransac``
    (calib.py:84-89): (n_hyp, 4) indices uniform over ``valid`` (J,)."""
    probs = jnp.asarray(valid).astype(dtype)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return np.asarray(jax.random.categorical(key, jnp.log(jnp.maximum(probs, 1e-30)),
                                             shape=(n_hyp, 4)))


def jax_photo_indices(valid, frame, dtype=jnp.float64):
    """The draws of the reference facade's ``process_frame`` call: key
    ``PRNGKey(frame)`` split over the histories (vio.py:479, calib.py:162),
    one (32, 4) draw per history of ``valid`` (Fh, J). Returns (Fh, 32, 4)."""
    keys = jax.random.split(jax.random.PRNGKey(frame), valid.shape[0])
    return np.stack([jax_gain_indices(k, v, dtype) for k, v in zip(keys, np.asarray(valid))])


def jax_photo_sampler(dtype=jnp.float64):
    """A sampler for the port facade's photometric calibration that repeats
    the reference's keyed draws (:func:`jax_photo_indices`)."""

    def draw(valid, frame, history=None):
        if isinstance(frame, torch.Tensor):  # the compiled facade's (1,) frame key
            frame = int(frame.reshape(-1)[0])
        return torch.from_numpy(jax_photo_indices(valid.cpu().numpy(), frame, dtype)).to(valid.device)

    return draw


def _frame_indices(jp, state, imgs):
    def one(s, im):
        pp = jimg.build_pyramid(s.prev_img, jp.lk_max_level)
        pc = jimg.build_pyramid(im, jp.lk_max_level)
        _, ok = jlk.track(pp, pc, s.pts, (s.ids >= 0) & s.has_prev, half_win=jp.win_half,
                          n_iters=jp.lk_iters, min_eig_thr=jp.min_eig_thr)
        return jax_sample_indices(ok, s.next_id, jp.ransac_hypotheses)

    return jax.vmap(one)(state, imgs)


# compiled once per tracker configuration, as the reference's tracker is
_frame_indices_jit = jax.jit(_frame_indices, static_argnums=0)


def jax_frame_indices(jp, state, imgs):
    """Regenerate, per agent, the RANSAC indices the reference's
    track_frame_batch draws inside _track_core."""
    return np.asarray(_frame_indices_jit(jp, state, imgs))


# ---------------------------------------------------------------------------
# the reference's scripts, run through both packages
# ---------------------------------------------------------------------------


def reference_script(name: str):
    """``scripts/{name}.py`` of the reference as a module named ``name``
    (its scripts import one another by that name: ``import ate_report as
    ar``), loaded once; the periodic stack dump ``ate_report`` starts is
    switched off again."""
    if name not in sys.modules:
        scripts = str(REPO / "scripts")
        if scripts not in sys.path:
            sys.path.insert(0, scripts)
        spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
        faulthandler.cancel_dump_traceback_later()
    return sys.modules[name]


def float64(cls):
    """A ``VioParams`` class that builds its parameters in float64 (patched
    over a package's class, so a script's facades run in float64)."""
    def make(*args, **kwargs):
        return cls(*args, **kwargs)._replace(dtype="float64")

    return make


def _jax_tracker_state(st):
    return jtrk.TrackerState(**{k: jnp.asarray(getattr(st, k).numpy())
                                for k in jtrk.TrackerState.__dataclass_fields__})


def snap_gains(v, ref) -> float:
    """Hold the port's photometric gains to the reference's ``ref`` state
    (its ``PhotoState`` after the same frame) to 1e-12, then take the
    reference's bits. The next frame's corrected image is affine in the
    integer raw values, so FAST scores that are equal in exact arithmetic
    differ by rounding only, and an ulp between the two packages' gains
    (their reductions run in another order) would rank or suppress such
    candidates the other way: the same bits make the detections the same.
    Returns the largest difference taken away."""
    st = v.photo.state
    rp = torch.from_numpy(np.array(ref.params_pt))
    assert int(st.frame_ptr) == int(ref.frame_ptr) and int(st.n_frames) == int(ref.n_frames)
    err = float((st.params_pt - rp).abs().max())
    assert err <= 1e-12, err
    v.photo = dataclasses.replace(v.photo, state=dataclasses.replace(st, params_pt=rp))
    return err


def with_reference_draws(v, ref_states, snapped):
    """The port's facade ``v`` drawing what the reference draws: RANSAC
    indices from the reference's draw on the port's tracker state and the
    image the tracker is about to see (corrected when the photometric
    calibration is on), the reference's keyed photometric and collaboration
    draws; after each frame its gains are held to the reference's
    (``ref_states``: frame -> the reference's photometric state) and take
    their bits (:func:`snap_gains`; the differences go to ``snapped``)."""
    if v.photo is not None:
        v.photo_sampler = jax_photo_sampler()
    if getattr(v, "_db", None) is not None:
        v.sampler = jax_keyed_sampler()
    jp = jtrk.TrackerParams(**v._tracker_params._asdict())
    inner = v.process_image_measurement

    def process_image_measurement(t_cam, seq, img, ransac_idx=None):
        cor = torch.as_tensor(img, dtype=v.params.tdtype, device=v.device)
        if v.photo is not None:
            a, b = v.photo.state.current().unbind(-1)
            cor = tcalib.correct_image(cor, a, b, params_ps=v.photo.ps).to(v.params.tdtype)
        idx = jax_frame_indices(jp, _jax_tracker_state(v._tracker_state),
                                jnp.asarray(cor.numpy())[None])
        applied = inner(t_cam, seq, img, ransac_idx=t(np.asarray(idx)))
        if v.photo is not None:
            snapped.append(snap_gains(v, ref_states[seq]))
        return applied

    v.process_image_measurement = process_image_measurement
    return v


def recording(v, states):
    """The reference's facade ``v``, keeping its photometric state after
    each frame in ``states`` (frame -> state)."""
    inner = v.process_image_measurement

    def process_image_measurement(t_cam, seq, img):
        applied = inner(t_cam, seq, img)
        if getattr(v, "_photo_state", None) is not None:
            states[seq] = jax.tree.map(np.asarray, v._photo_state)
        return applied

    v.process_image_measurement = process_image_measurement
    return v


def mesh_desc_inputs():
    """The inputs of the reference's mesh-descriptor test
    (tests/test_mesh_desc.py), as the reference's JAX objects: two 3 s
    agents with per-landmark descriptors, 8 words, every agent's ring
    holding its own snapshot. Returns (fs, slots, db, words)."""
    from test_collab import PARAMS, run_agent
    from test_mesh_desc import _with_descriptors
    from x_multi_agent_tpu.parallel import collab as jcollab
    from x_multi_agent_tpu.place_recognition import database as jdb
    from x_multi_agent_tpu.place_recognition.vocabulary import train_kmajority

    rng = np.random.default_rng(5)
    desc_table = rng.integers(0, 256, (40, 32)).astype(np.uint8)
    words = train_kmajority(desc_table, 8, 4).words
    va, _ = run_agent((0.0, 0.0, 0.0), 1e-3)
    vb, _ = run_agent((0.25, 0.0, 0.0), 0.5)

    def pair(*xs):
        return jax.tree.map(lambda *v: jnp.stack(v), *xs)

    slots = pair(_with_descriptors(va.slots, desc_table), _with_descriptors(vb.slots, desc_table))
    fs = pair(va.fs, vb.fs)
    dd = jdb.DbDims(n_keyframes=3, n_words=int(words.shape[0]), max_agents=2)

    def build_db(f, s):
        proto = jcollab.extract_payload_desc(PARAMS, f, s)
        db = jdb.KeyframeDB.zero(dd, jax.tree.map(jnp.zeros_like, proto))
        return jdb.add_keyframe(dd, db, proto, jnp.asarray(words))

    return fs, slots, jax.vmap(build_db)(fs, slots), words


def mesh_four_agents(desc_inputs):
    """Four agents (two per rank of 2) with descriptors, on the port's side:
    the two agents of :func:`mesh_desc_inputs` and their copies a few cm
    off, each ring holding its own snapshot and its next peer's. Returns
    (fs, slots, db, words) on the CPU in float64."""
    from test_collab import PARAMS
    from x_multi_agent_torch.parallel import collab as tcollab
    from x_multi_agent_torch.place_recognition import database as tdb
    from x_multi_agent_torch.utils import tree

    tp = port_params(PARAMS)
    fs, slots, _, words = desc_inputs
    rows = torch.tensor([0, 1, 0, 1])
    fs4 = tree.map_leaves(lambda x: x[rows], to_port(fs))
    slots4 = tree.map_leaves(lambda x: x[rows], to_port(slots))
    shift = torch.tensor([0.0, 0.0, 0.03, -0.02], dtype=torch.float64)
    fs4 = dataclasses.replace(fs4, vision=dataclasses.replace(
        fs4.vision, p_arr=fs4.vision.p_arr + shift[:, None, None]))
    w = t(words)
    dd = tdb.DbDims(n_keyframes=3, n_words=int(w.shape[0]), max_agents=4)
    own = tcollab.extract_payload_desc(tp, fs4, slots4)
    peer = tree.map_leaves(lambda x: x[(torch.arange(4) + 1) % 4], own)
    db = tdb.add_keyframe(dd, tdb.add_keyframe(dd, tdb.KeyframeDB.zero(dd, own), own, w), peer, w)
    return fs4, slots4, db, w
