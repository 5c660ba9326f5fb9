"""PyTorch port: the compiled keyframe step (``collab.maybe_add_keyframe_fn``).

The keyframe step runs after every applied frame on the collaborative path:
the selection heuristic, then, where it fires, the snapshot into the agent's
keyframe ring with its VLAD. Compiled, it is one CUDA graph per call with the
database and ``KfMeta`` as the carry. These tests hold:

* on the CPU (its plain path on the staged buffers): the program against the
  eager step on four agents with descriptors, every leaf bit for bit over
  calls where the heuristic fires for some agents and not for others, the
  database threading from call to call, and the body capture-safe under
  ``CaptureWitness`` after its first call;
* on a card (``gpu``-marked, skipped here): 16 orbit agents through the
  compiled frame step at 480x640 with descriptors, 24 frames, the compiled
  keyframe step against the eager one, every leaf bit for bit after every
  frame.

JAX is imported inside the CPU tests only, so the card's machine runs the
``gpu`` test with ``python -m pytest --noconftest -m gpu
tests/test_torch_keyframe_graph.py``.
"""
import dataclasses

import pytest
import torch

from test_torch_graph import CaptureWitness
from x_multi_agent_torch import configs
from x_multi_agent_torch.parallel import collab
from x_multi_agent_torch.place_recognition import database as db_mod
from x_multi_agent_torch.utils import tree


def _equal(got, ref) -> list:
    """Paths of the leaves of two trees that differ (bit for bit)."""
    g, r = tree.leaves(got), tree.leaves(ref)
    assert len(g) == len(r)
    return [i for i, (a, b) in enumerate(zip(g, r)) if not torch.equal(a, b)]


def _four_agents():
    from test_collab import PARAMS
    from torch_helpers import mesh_desc_inputs, mesh_four_agents, port_params

    fs, slots, db, words = mesh_four_agents(mesh_desc_inputs())
    dd = db_mod.DbDims(n_keyframes=3, n_words=int(words.shape[0]), max_agents=4)
    return port_params(PARAMS), dd, fs, slots, db, words


def _kf_meta(fs, frames_since):
    """Bookkeeping far from every agent's anchor, ``frames_since`` frames
    after the last keyframe."""
    a = fs.cov.shape[0]
    return collab.KfMeta(last_kf_pos=torch.full((a, 3), 5.0, dtype=fs.cov.dtype),
                         frames_since=torch.tensor(frames_since, dtype=torch.int32))


def test_compiled_keyframe_step_equals_eager_on_the_cpu():
    params, dd, fs, slots, db, words = _four_agents()
    prog = collab.maybe_add_keyframe_fn(params, dd)
    kf_meta = _kf_meta(fs, [11, 3, 20, 11])
    enabled = torch.tensor([True, True, True, False])
    db_e, kf_e = db, kf_meta
    db_c, kf_c = db, kf_meta
    fired = 0
    for step in range(4):
        # move the agents a little each call so that the ring's snapshots differ
        fs = dataclasses.replace(fs, vision=dataclasses.replace(
            fs.vision, p_arr=fs.vision.p_arr + 0.01 * (step + 1)))
        db_e, kf_e, sel_e = collab.maybe_add_keyframe(params, dd, words, fs, slots, db_e, kf_e,
                                                      enabled=enabled)
        db_c, kf_c, sel_c = prog(db_c, kf_c, words, fs, slots, enabled)
        assert _equal((db_c, kf_c, sel_c), (db_e, kf_e, sel_e)) == [], step
        fired += int(sel_e.sum())
        # the returned carry is the program's buffers: the next call reads them in place
        assert db_c.wptr is prog._built[next(iter(prog._built))][0][0].wptr
    assert 0 < fired < 4 * 4, "the heuristic must fire for some agents and not for all"
    assert prog.captures == 1


def test_compiled_keyframe_step_is_capture_safe():
    params, dd, fs, slots, db, words = _four_agents()
    prog = collab.maybe_add_keyframe_fn(params, dd)
    kf_meta = _kf_meta(fs, [11, 11, 11, 11])
    enabled = torch.ones(4, dtype=torch.bool)
    prog(db, kf_meta, words, fs, slots, enabled)  # fills the constant caches
    with CaptureWitness() as w:
        prog(db, kf_meta, words, fs, slots, enabled)
    w.assert_clean()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_compiled_keyframe_step_equals_eager_bit_for_bit_on_the_card(cuda):
    from x_multi_agent_torch.place_recognition import descriptors
    from x_multi_agent_torch.place_recognition.vocabulary import train_kmajority
    from x_multi_agent_torch.utils.scene import orbit_dataset, orbit_start
    from x_multi_agent_torch.vio import vio
    from x_multi_agent_torch.vio.frame_step import CompiledFrameStep
    from x_multi_agent_torch.vision import tracker

    a, n, h, w = 16, 24, 480, 640
    params = configs.flagship_params()
    tparams = configs.flagship_tracker(200)._replace(compute_descriptors=True)
    cam = configs.flagship_camera(h, w)
    frames, (times, seqs, w_ms, a_ms) = orbit_dataset(a, n, h, w, cuda)
    p0, v0, q0 = orbit_start(a)
    fs, slots = vio.init_at_time(params, 0.0, a, cuda, p=p0, v=v0, q=q0)
    tstate = tracker.TrackerState.zero(tparams, a, h, w, device=cuda)
    step = CompiledFrameStep(params, tparams, cam, seed=0)
    dd = db_mod.DbDims(n_keyframes=15, n_words=64, max_agents=a)
    prog = collab.maybe_add_keyframe_fn(params, dd)
    fired = 0
    for k in range(n):
        tstate, fs, slots, _, applied = step(tstate, fs, slots, frames[k], times[k], seqs[k],
                                             w_ms[k], a_ms[k], times[k][:, -1])
        if k == 0:
            d0, ok0 = descriptors.compute(frames[0], tstate.pts, tstate.ids >= 0)
            words = torch.from_numpy(train_kmajority(d0[ok0].cpu().numpy(), 64, seed=0).words)
            words = words.to(cuda)
            db_e = db_mod.KeyframeDB.zero(dd, collab.extract_payload_desc(params, fs, slots))
            kf_e = collab.KfMeta.zero(a, fs.cov.dtype, cuda)
            db_c, kf_c = db_e, kf_e
        db_e, kf_e, sel_e = collab.maybe_add_keyframe(params, dd, words, fs, slots, db_e, kf_e,
                                                      enabled=applied)
        db_c, kf_c, sel_c = prog(db_c, kf_c, words, fs, slots, applied)
        assert _equal((db_c, kf_c, sel_c), (db_e, kf_e, sel_e)) == [], k
        fired += int(sel_e.sum())
    assert prog.graphs.captured == 1
    print(f"keyframes selected over {n} frames of {a} agents: {fired}")
