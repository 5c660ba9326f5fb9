"""PyTorch port vs the JAX reference: place recognition (steered-BRIEF
descriptors, Hamming kNN matching, vocabularies and the DBoW3 reader, VLAD,
the keyframe database) and the tracker's descriptor branch.

JAX runs in float64 on the CPU as the rest of the suite, the port on CPU
tensors in float64. Integer, boolean and uint8 leaves (descriptor bytes,
match indices, word ids, VLADs, served flags) must match exactly, float
leaves within 1e-8 of each leaf's max. Descriptor bits are compared
exactly wherever the comparison's margin |va - vb| exceeds 1e-9: below it
a bit may flip between two correct float64 implementations. On a card
(``gpu``-marked, skipped here) the card's float32 descriptors are held so
against the CPU's float64 ones wherever the margin exceeds float32's
rounding of the samples (``MARGIN_F32``).
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_collab import PARAMS
from torch_helpers import assert_tree_close, np_tree, orbit_frames, t, to_port
from x_multi_agent_tpu.parallel import collab as jcollab
from x_multi_agent_tpu.place_recognition import database as jdb
from x_multi_agent_tpu.place_recognition import descriptors as jdesc
from x_multi_agent_tpu.place_recognition import vlad as jvlad
from x_multi_agent_tpu.place_recognition import vocabulary as jvoc
from x_multi_agent_torch.parallel import payload as tpay
from x_multi_agent_torch.place_recognition import database as tdb
from x_multi_agent_torch.place_recognition import descriptors as tdesc
from x_multi_agent_torch.place_recognition import vlad as tvlad
from x_multi_agent_torch.place_recognition import vocabulary as tvoc

MARGIN = 1e-9
# gray levels: float32 sample points near x = 640 round by ~4e-5 px, which
# moves a sample of the smoothed image by ~2e-3 at its steepest
MARGIN_F32 = 1e-2


def _desc(rng, n):
    return rng.integers(0, 256, (n, 32)).astype(np.uint8)


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    """Two agents' rendered 120x160 frames and keypoints: a grid over the
    image (some near the border, so the patch test fails) plus jitter."""
    imgs, _ = orbit_frames(2, 1, 120, 160)
    rng = np.random.default_rng(0)
    gx, gy = np.meshgrid(np.linspace(5, 155, 9), np.linspace(5, 115, 7))
    grid = np.stack([gx.ravel(), gy.ravel()], -1)
    pts = grid[None] + rng.uniform(-0.5, 0.5, size=(2,) + grid.shape)
    valid = rng.random(pts.shape[:2]) > 0.1
    return imgs[0], pts, valid


def _bits(desc):
    return np.unpackbits(np.asarray(desc), axis=-1, bitorder="little")


def test_compute_matches_jax(frames):
    imgs, pts, valid = frames
    ref_desc, ref_ok = jax.vmap(jdesc.compute)(*map(jnp.asarray, (imgs, pts, valid)))
    got_desc, got_ok = tdesc.compute(t(imgs), t(pts), t(valid))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    assert got_desc.dtype == torch.uint8
    stable = tdesc.bit_margin(t(imgs), t(pts)).numpy() > MARGIN
    g, r = _bits(got_desc.numpy()), _bits(ref_desc)
    np.testing.assert_array_equal(g[stable], r[stable])
    # the margin test leaves almost every bit to the exact comparison
    assert stable.mean() > 0.99 and got_ok.sum() > 40 and (~got_ok).sum() > 5


def test_compute_rotation_invariance_as_jax(frames):
    """A keypoint's descriptor barely changes under an in-plane rotation of
    the image about it (the orientation step), in the port as in the
    reference: the port's bits agree with the reference's, and the
    Hamming distance to the unrotated descriptor is small in both."""
    from scipy.ndimage import rotate

    imgs, _, _ = frames
    img = imgs[0]
    rot = rotate(img, 30.0, reshape=False, order=3, mode="nearest")
    c = np.array([[[79.5, 59.5]]])
    ok = np.ones((1, 1), bool)
    stack = np.stack([img, rot])[:, None]
    ref = [np.asarray(jdesc.compute(jnp.asarray(s[0]), jnp.asarray(c[0]), jnp.asarray(ok[0]))[0])
           for s in stack]
    got = [tdesc.compute(t(s), t(c), t(ok))[0].numpy()[0] for s in stack]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    d = int(np.unpackbits(got[0] ^ got[1]).sum())
    assert d < 64


def test_hamming_and_knn2_match_with_ties():
    """Duplicated candidates (argmin ties go to the first index), a row of
    b with one valid candidate only (second distance INT32_MAX) and one with
    none, invalid rows of a."""
    rng = np.random.default_rng(1)
    a_n, b_n = 12, 10
    desc_b = _desc(rng, b_n)
    desc_b[7] = desc_b[2]  # tie
    desc_a = desc_b[rng.integers(0, b_n, a_n)] ^ (rng.random((a_n, 32)) < 0.03).astype(np.uint8)
    desc_a[0] = desc_b[2]
    desc_a[1] = desc_b[4]
    desc_a = np.stack([desc_a, desc_a, desc_a])
    desc_b = np.stack([desc_b, desc_b, desc_b])
    valid_a = rng.random((3, a_n)) > 0.2
    valid_a[:, :2] = True
    valid_b = np.ones((3, b_n), bool)
    valid_b[1] = False
    valid_b[1, 4] = True  # one candidate: d2 = INT32_MAX
    valid_b[2] = False  # none
    ref_h = jax.vmap(jdesc.hamming_matrix)(jnp.asarray(desc_a), jnp.asarray(desc_b))
    got_h = tdesc.hamming_matrix(t(desc_a), t(desc_b))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
    for ratio, abs_thr in ((0.8, 60.0), (0.95, 40.0)):
        ref = jax.vmap(lambda *x: jdesc.knn2_match(*x, ratio, abs_thr))(
            *map(jnp.asarray, (desc_a, valid_a, desc_b, valid_b)))
        got = tdesc.knn2_match(*map(t, (desc_a, valid_a, desc_b, valid_b)), ratio, abs_thr)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert got[1][0].any() and got[1][1].any() and not got[1][2].any()
    assert int(got[0][0, 0]) == 2  # the tie went to the first index


def test_tracker_descriptor_branch_matches_jax():
    """``compute_descriptors=True``: the tracker's matches carry the
    descriptors of the tracked features (same inputs and RANSAC draws)."""
    from torch_helpers import jax_frame_indices, stack
    from x_multi_agent_tpu.vision import camera as jcam
    from x_multi_agent_tpu.vision import tracker as jtrk
    from x_multi_agent_torch import configs
    from x_multi_agent_torch.vision import tracker as ttrk

    h, w = 120, 160
    trk_p = configs.flagship_tracker(40)._replace(compute_descriptors=True)
    jp = jtrk.TrackerParams(**trk_p._asdict())
    cam = configs.flagship_camera(h, w)
    imgs, _ = orbit_frames(2, 2, h, w)
    jst = stack(jtrk.TrackerState.zero(jp, h, w, jnp.float64), 2)
    tst = to_port(jst)
    for k in range(2):
        idx = jax_frame_indices(jp, jst, jnp.asarray(imgs[k]))
        jst, jm = jtrk.track_frame_batch(jp, jcam.Camera(*cam), jst, jnp.asarray(imgs[k]))
        tst, tm_ = ttrk.track_frame_batch(trk_p, cam, tst, t(imgs[k]), ransac_idx=t(idx))
    np.testing.assert_array_equal(tm_.desc_valid.numpy(), np.asarray(jm.desc_valid))
    sel = tm_.desc_valid.numpy()
    pts = tst.pts  # tracked features' current positions
    stable = tdesc.bit_margin(t(imgs[1]), pts).numpy() > MARGIN
    g, r = _bits(tm_.desc.numpy()), _bits(jm.desc)
    np.testing.assert_array_equal(g[sel & stable.all(-1)], r[sel & stable.all(-1)])
    assert sel.sum() > 20


@pytest.mark.gpu
def test_card_descriptors_match_cpu_float64():
    """The image fleet's frame 0 (16 agents, 480x640) on the card in
    float32, at the keypoints its tracker detects, against the CPU in
    float64 on the same frame and keypoints: the same ``ok`` flags, every
    bit whose margin exceeds ``MARGIN_F32`` equal, those at least 99 % of
    the bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from x_multi_agent_torch import configs
    from x_multi_agent_torch.utils import bench
    from x_multi_agent_torch.vision import tracker as ttrk

    dev, (a, h, w) = torch.device("cuda"), (16, 480, 640)
    frames, _ = bench.orbit_frames(a, 1, h, w, dev)
    img = frames[0]
    tp = configs.flagship_tracker(200)
    st, _ = ttrk.track_frame_batch(tp, configs.flagship_camera(h, w),
                                   ttrk.TrackerState.zero(tp, a, h, w, device=dev), img)
    valid = st.ids >= 0
    card, ok = tdesc.compute(img, st.pts, valid)
    args = (img.double().cpu(), st.pts.double().cpu())
    cpu, ok_cpu = tdesc.compute(*args, valid.cpu())
    assert torch.equal(ok.cpu(), ok_cpu) and int(ok_cpu.sum()) >= 100 * a
    stable = tdesc.bit_margin(*args)[ok_cpu] > MARGIN_F32
    bits_card, bits_cpu = (tdesc.unpack_bits(d.cpu())[ok_cpu] for d in (card, cpu))
    assert torch.equal(bits_card[stable], bits_cpu[stable])
    assert float(stable.double().mean()) >= 0.99


# ---------------------------------------------------------------------------
# vocabularies
# ---------------------------------------------------------------------------


def test_transform_with_duplicated_words():
    rng = np.random.default_rng(2)
    words = _desc(rng, 16)
    words[9] = words[3]  # tie: word 3 must win
    desc = np.concatenate([words[[3, 9, 0]], _desc(rng, 40)])[None].repeat(2, 0)
    ref = jax.vmap(lambda d: jvoc.transform(jnp.asarray(words), d))(jnp.asarray(desc))
    got = tvoc.transform(t(words), t(desc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32 and int(got[0, 1]) == 3


def test_train_kmajority_same_words():
    rng = np.random.default_rng(3)
    descs = _desc(rng, 300)
    for n_words, seed in ((16, 0), (8, 5)):
        ref = jvoc.train_kmajority(descs, n_words, 5, seed)
        got = tvoc.train_kmajority(descs, n_words, 5, seed)
        np.testing.assert_array_equal(got.words, ref.words)


def test_hierarchical_vocabulary_matches_jax():
    rng = np.random.default_rng(4)
    centers = _desc(rng, 6)
    descs = centers[rng.integers(0, 6, 240)] ^ (rng.random((240, 32)) < 0.05).astype(np.uint8)
    ref = jvoc.train_hierarchical(descs, k=3, depth=2, n_iters=4, seed=1)
    got = tvoc.train_hierarchical(descs, k=3, depth=2, n_iters=4, seed=1)
    for name in ("nodes", "children", "word_id", "words"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    np.testing.assert_array_equal(tvoc.transform_tree(got, descs[:50]),
                                  jvoc.transform_tree(ref, descs[:50]))
    assert got.n_words == ref.n_words > 3


# QuickLZ level-1 blocks built from the decoder's spec: 3-byte header
# (flags bit0 = compressed, bit1 = 9-byte header; sizes), then 32-bit
# control words (LSB first, a sentinel bit 31): 0 = literal, 1 = match token
# (low nibble = length - 2, bits 4-15 = hash of the source's first 3 bytes).
def _qlz_match_block() -> tuple:
    """"abcdefgh" as literals, a 6-byte match of position 0, 10 literals."""
    tail = b"0123456789"
    h = jvoc._hash3(*b"abc")
    token = struct.pack("<H", (h << 4) | (6 - 2))
    body = struct.pack("<I", (1 << 8) | (1 << 31)) + b"abcdefgh" + token + tail
    src = bytes([1, 3 + len(body), 24]) + body
    return src, b"abcdefgh" + b"abcdef" + tail


def _qlz_literals(data: bytes) -> bytes:
    """A compressed-flagged block of literals only (31 per control word)."""
    body = b"".join(struct.pack("<I", 1 << 31) + data[i : i + 31]
                    for i in range(0, len(data), 31))
    return struct.pack("<BII", 3, 9 + len(body), len(data)) + body


def _qlz_stored(data: bytes) -> bytes:
    return struct.pack("<BII", 2, 9 + len(data), len(data)) + data


def test_qlz1_decompress_matches_jax():
    src, want = _qlz_match_block()
    data = bytes(np.random.default_rng(5).integers(0, 256, 100).astype(np.uint8))
    for block, expect in ((src, want), (_qlz_literals(data), data), (_qlz_stored(data), data),
                          (bytes([0, 3 + 5, 5]) + data[:5], data[:5])):
        got = tvoc.qlz1_decompress(block)
        assert got == jvoc.qlz1_decompress(block) == expect


def _dbow3_stream(words: np.ndarray) -> bytes:
    """A two-level DBoW3 node stream: root, then one node per word."""
    n = len(words)
    out = struct.pack("<iiii", n, 1, 0, 0)
    for i, wd in enumerate(words):
        out += struct.pack("<IId", i + 1, 0, 1.0 / n) + struct.pack("<iii", 32, 1, 0) + wd.tobytes()
    out += struct.pack("<I", n)
    for i in range(n):  # word ids in reverse node order
        out += struct.pack("<II", i, n - i)
    return out


@pytest.mark.parametrize("compressed", [False, True])
def test_load_dbow3_matches_jax(tmp_path, compressed):
    words = _desc(np.random.default_rng(6), 5)
    stream = _dbow3_stream(words)
    head = struct.pack("<QBI", 88877711233, int(compressed), len(words) + 1)
    if compressed:  # one stored chunk, one compressed chunk
        half = len(stream) // 2
        body = struct.pack("<I", 2) + _qlz_stored(stream[:half]) + _qlz_literals(stream[half:])
    else:
        body = stream
    path = tmp_path / "voc.dbow3"
    path.write_bytes(head + body)
    got, ref = tvoc.load_dbow3(str(path)), jvoc.load_dbow3(str(path))
    np.testing.assert_array_equal(got.words, ref.words)
    np.testing.assert_array_equal(got.words, words[::-1])
    assert (got.k, got.levels) == (ref.k, ref.levels) == (5, 1)
    path.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        tvoc.load_dbow3(str(path))


# ---------------------------------------------------------------------------
# VLAD and the keyframe database
# ---------------------------------------------------------------------------


def test_vlad_matches_jax():
    rng = np.random.default_rng(7)
    words = _desc(rng, 16)
    desc = np.stack([_desc(rng, 30), _desc(rng, 30)])
    desc[1, :10] = desc[0, :10]
    valid = rng.random((2, 30)) > 0.3
    ref = jax.vmap(lambda d, v: jvlad.compute_vlad(jnp.asarray(words), d, v))(
        jnp.asarray(desc), jnp.asarray(valid))
    got = tvlad.compute_vlad(t(words), t(desc), t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref_s = jvlad.vlad_score(ref[0], ref[1])
    got_s = tvlad.vlad_score(got[0], got[1])
    assert got_s.dtype == torch.float32 and float(got_s) == float(ref_s)
    assert 0.5 < float(got_s) < 1.0


def _payloads(rng, a, n_kf):
    """``n_kf`` keyframe payloads per agent from a zero state with random
    SLAM descriptors (the first two agents share theirs)."""
    from x_multi_agent_tpu.ekf.state import VisionState

    dims = PARAMS.cfg.dims
    out = []
    for _ in range(n_kf):
        desc = _desc(rng, dims.n_features)
        per = []
        for i in range(a):
            d = desc if i < 2 else _desc(rng, dims.n_features)
            per.append(jcollab.make_payload(
                dims, 0.1 * len(out) + i, VisionState.zero(dims, jnp.float64),
                jnp.eye(dims.d) * (1.0 + i), slam_desc=jnp.asarray(d),
                slam_desc_valid=jnp.asarray(rng.random(dims.n_features) > 0.2)))
        out.append(jax.tree.map(lambda *x: jnp.stack(x), *per))
    return out


def test_database_matches_jax():
    """Five keyframes into a 3-slot ring (wraps), then queries from every
    agent with duplicated VLADs (the first index wins the tie), served-once
    semantics and get_keyframe."""
    rng = np.random.default_rng(8)
    a, words = 3, _desc(rng, 8)
    dd = jdb.DbDims(n_keyframes=3, n_words=8, max_agents=4)
    tdd = tdb.DbDims(*dd)
    pays = _payloads(rng, a, 5)
    jdbs = jax.vmap(lambda p: jdb.KeyframeDB.zero(dd, p))(pays[0])
    tdbs = tdb.KeyframeDB.zero(tdd, to_port(pays[0]))
    assert_tree_close(tdbs, np_tree(jdbs), 0.0, "zero")
    for p in pays:
        jdbs = jax.vmap(lambda d, x: jdb.add_keyframe(dd, d, x, jnp.asarray(words)))(jdbs, p)
        tdbs = tdb.add_keyframe(tdd, tdbs, to_port(p), t(words))
    assert_tree_close(tdbs, np_tree(jdbs), 0.0, "added")
    # duplicate a keyframe's VLAD in the ring: the lower slot wins the tie
    jdbs = jax.tree.map(lambda x: x, jdbs)
    dup = np.asarray(jdbs.vlad).copy()
    dup[:, 2] = dup[:, 0]
    jdbs = jdb.KeyframeDB(payload=jdbs.payload, vlad=jnp.asarray(dup), served=jdbs.served,
                          valid=jdbs.valid, wptr=jdbs.wptr)
    tdbs = to_port(jdbs)
    for req in (0, 1, 1, 3):
        q = np.asarray(jdbs.vlad)[:, 0] if req != 3 else np.asarray(jdbs.vlad)[[1, 2, 0], 1]
        ref = jax.vmap(lambda d, v: jdb.find_candidate_scored(d, req, v, 0.3))(jdbs, jnp.asarray(q))
        got = tdb.find_candidate_scored(tdbs, req, t(q), 0.3)
        for name, g, r in zip(("idx", "found", "score"), got[:3], ref[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        jdbs, tdbs = ref[3], got[3]
        assert_tree_close(tdbs, np_tree(jdbs), 0.0, f"db after {req}")
        kf_ref = jax.vmap(jdb.get_keyframe)(jdbs, ref[0])
        assert_tree_close(tdb.get_keyframe(tdbs, got[0]), np_tree(kf_ref), 0.0, "keyframe")
    assert bool(tdbs.served.any()) and not bool(tdbs.served.all())
    with pytest.raises(ValueError, match="served bitmap"):
        tdb.find_candidate(tdbs, 4, t(q), 0.3)


def test_make_payload_fields_match_jax():
    """``make_payload`` with every descriptor, observation and track field
    given, and the defaults."""
    from x_multi_agent_tpu.ekf.state import VisionState

    rng = np.random.default_rng(9)
    dims = PARAMS.cfg.dims
    m, n, kt = dims.n_poses, dims.n_features, 5
    kw = dict(slam_desc=_desc(rng, n), slam_desc_valid=rng.random(n) > 0.5,
              slam_obs=rng.normal(size=(n, 2)), trk_obs=rng.normal(size=(kt, m, 2)),
              trk_mask=rng.random((kt, m)) > 0.5, trk_desc=_desc(rng, kt),
              trk_desc_valid=rng.random(kt) > 0.5, trk_id=rng.integers(-1, 9, kt).astype(np.int32),
              slam_id=rng.integers(-1, 9, n).astype(np.int32))
    vis = VisionState.zero(dims, jnp.float64)
    cov = jnp.eye(dims.d) * 2.0
    for given in (kw, {}):
        ref = jcollab.make_payload(dims, 0.5, vis, cov, n_collab_tracks=kt,
                                   **{k: jnp.asarray(v) for k, v in given.items()})
        refb = jax.tree.map(lambda x: jnp.stack([x, x]), ref)
        got = tpay.make_payload(dims, t([0.5, 0.5]), to_port(jax.tree.map(
            lambda x: jnp.stack([x, x]), vis)), t(np.stack([cov, cov])), n_collab_tracks=kt,
            **{k: t(np.stack([v, v])) for k, v in given.items()})
        assert_tree_close(got, np_tree(refb), 1e-12, "payload")
