"""Binary visual vocabularies (port of
``x_multi_agent_tpu.place_recognition.vocabulary``).

A vocabulary is a flat (W, 32) uint8 table of word centroids; quantization
(:func:`transform`) is an on-device argmin over Hamming distances, the
exact nearest word. The rest is host-side numpy, as in the reference:

  * the DBoW3 binary vocabulary reader (magic 88877711233; the node stream
    may be QuickLZ-level-1 compressed, decoded by :func:`qlz1_decompress`);
  * k-majority training (Hamming k-means with bitwise-majority centroids),
    flat and hierarchical, and the hierarchical tree walk.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from .descriptors import hamming_matrix

# ---------------------------------------------------------------------------
# QuickLZ level 1 decompression. Header: flags byte (bit0 = compressed,
# bit1 = long header) then compressed and decompressed sizes (1 byte each,
# or 4 with the long header). Stream: 32-bit control words, LSB first; a set
# bit is a match token carrying a 12-bit hash of the match source, resolved
# against a hash table the decoder rebuilds from its own output.
# ---------------------------------------------------------------------------

_BITLUT = [4, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0]


def _qlz_header(src: bytes):
    """(flags, header length, compressed size, decompressed size)."""
    flags = src[0]
    if flags & 2:
        csize, dsize = struct.unpack_from("<II", src, 1)
        return flags, 9, csize, dsize
    return flags, 3, src[1], src[2]


def _hash3(b0, b1, b2):
    fetch = b0 | (b1 << 8) | (b2 << 16)
    return ((fetch >> 12) ^ fetch) & 0xFFF


def qlz1_decompress(src: bytes) -> bytes:
    """Decode one QuickLZ level-1 block (header included)."""
    flags, hlen, _, dsize = _qlz_header(src)
    if not (flags & 1):  # stored uncompressed
        return bytes(src[hlen : hlen + dsize])

    dst = bytearray(dsize)
    hash_table = [0] * 4096
    d = 0  # write position
    s = hlen
    cword = 1
    last_matchstart = dsize - 1 - 6 - 4  # UNCONDITIONAL_MATCHLEN + UNCOMPRESSED_END
    last_hashed = -1

    def update_hashes(upto):  # hash positions last_hashed+1 .. upto
        nonlocal last_hashed
        while last_hashed < upto:
            last_hashed += 1
            p = last_hashed
            hash_table[_hash3(dst[p], dst[p + 1], dst[p + 2])] = p

    while True:
        if cword == 1:
            cword = struct.unpack_from("<I", src, s)[0]
            s += 4
        if cword & 1:
            cword >>= 1
            fetch = src[s] | (src[s + 1] << 8) | (src[s + 2] << 16)
            pos = hash_table[(fetch >> 4) & 0xFFF]
            if fetch & 0xF:
                matchlen = (fetch & 0xF) + 2
                s += 2
            else:
                matchlen = src[s + 2]
                s += 3
            for i in range(matchlen):  # overlapping copies are sequential
                dst[d + i] = dst[pos + i]
            d += matchlen
            update_hashes(d - matchlen)  # inclusive of the match start
            last_hashed = d - 1
        elif d < last_matchstart:
            n = _BITLUT[cword & 0xF]
            dst[d : d + n] = src[s : s + n]
            cword >>= n
            d += n
            s += n
            update_hashes(d - 3)
        else:
            while d < dsize:
                if cword == 1:
                    s += 4
                    cword = 1 << 31
                dst[d] = src[s]
                d += 1
                s += 1
                cword >>= 1
            return bytes(dst)


# ---------------------------------------------------------------------------
# DBoW3 binary vocabulary reader
# ---------------------------------------------------------------------------

_DBOW3_MAGIC = 88877711233


class Vocabulary(NamedTuple):
    words: np.ndarray  # (W, D) uint8 leaf-word centroids (or a tensor)
    k: int = 0  # branching factor (informational)
    levels: int = 0

    @property
    def n_words(self) -> int:
        return int(self.words.shape[0])


def load_dbow3(path: str) -> Vocabulary:
    """Load a DBoW3 binary vocabulary (the reference's ``.yaml`` vocabulary
    files are this binary format despite the extension)."""
    with open(path, "rb") as fh:
        data = fh.read()
    (sig,) = struct.unpack_from("<Q", data, 0)
    if sig != _DBOW3_MAGIC:
        raise ValueError(f"{path}: not a DBoW3 binary vocabulary")
    compressed = data[8]
    (nnodes,) = struct.unpack_from("<I", data, 9)
    off = 13
    if compressed:
        (nchunks,) = struct.unpack_from("<I", data, off)
        off += 4
        stream = bytearray()
        for _ in range(nchunks):
            _, _, csize, _ = _qlz_header(data[off : off + 9])
            stream += qlz1_decompress(data[off : off + csize])
            off += csize
        stream = bytes(stream)
    else:
        stream = data[off:]

    o = 0
    k, levels, _scoring, _weighting = struct.unpack_from("<iiii", stream, o)
    o += 16
    descs = [None] * nnodes
    for _ in range(nnodes - 1):
        nid, _parent = struct.unpack_from("<II", stream, o)
        o += 16  # ids, then the node weight (float64)
        cols, _rows, _type = struct.unpack_from("<iii", stream, o)
        o += 12
        descs[nid] = np.frombuffer(stream, np.uint8, cols, o).copy()
        o += cols
    (n_words,) = struct.unpack_from("<I", stream, o)
    o += 4
    words = [None] * n_words
    for _ in range(n_words):
        wid, nid = struct.unpack_from("<II", stream, o)
        o += 8
        words[wid] = descs[nid]
    return Vocabulary(words=np.stack(words), k=k, levels=levels)


# ---------------------------------------------------------------------------
# training (host numpy) and the on-device transform
# ---------------------------------------------------------------------------


def _popcount_np(x):
    return np.unpackbits(x, axis=-1).sum(-1)


def _majority(members: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(members, axis=1)
    return np.packbits((bits.mean(0) >= 0.5).astype(np.uint8))


def train_kmajority(
    descriptors: np.ndarray, n_words: int, n_iters: int = 10, seed: int = 0
) -> Vocabulary:
    """Hamming k-means with bitwise-majority centroids (host numpy)."""
    rng = np.random.default_rng(seed)
    descs = np.asarray(descriptors, np.uint8)
    cents = descs[rng.choice(len(descs), n_words, replace=False)].copy()
    for _ in range(n_iters):
        assign = _popcount_np(descs[:, None, :] ^ cents[None, :, :]).argmin(1)
        for w in range(n_words):
            members = descs[assign == w]
            if len(members):
                cents[w] = _majority(members)
    return Vocabulary(words=cents)


def transform(words: torch.Tensor, descriptors: torch.Tensor) -> torch.Tensor:
    """Nearest-word ids: words (W, 32) x descriptors (..., N, 32) uint8 ->
    (..., N) int32; ties go to the first word."""
    return torch.argmin(hamming_matrix(descriptors, words), dim=-1).to(torch.int32)


class TreeVocabulary(NamedTuple):
    """Hierarchical k-ary vocabulary (DBoW3 ``Vocabulary::create`` parity:
    branching factor k, depth L, recursive k-majority clustering), stored
    flat, breadth-first: ``nodes`` (T, 32) per-node centroids, ``children``
    (T, k) int32 child ids (-1 none), ``word_id`` (T,) leaf word id (-1 for
    interior nodes), ``words`` (W, 32) the leaves in word-id order."""

    nodes: np.ndarray
    children: np.ndarray
    word_id: np.ndarray
    words: np.ndarray

    @property
    def n_words(self) -> int:
        return int(self.words.shape[0])


def train_hierarchical(
    descriptors: np.ndarray, k: int = 10, depth: int = 3, n_iters: int = 10, seed: int = 0,
) -> TreeVocabulary:
    """Hierarchical k-majority training: each node's member descriptors are
    clustered into k children, recursively, down to ``depth`` levels; the
    leaves become words (host numpy)."""
    rng = np.random.default_rng(seed)
    descs = np.asarray(descriptors, np.uint8)

    nodes = [np.zeros(32, np.uint8)]  # root (centroid unused)
    children: list = [[]]
    word_of: list = [-1]

    def cluster(member_idx: np.ndarray, level: int, node_id: int):
        if level == depth or len(member_idx) <= k:
            return  # node stays a leaf
        pts = descs[member_idx]
        kk = min(k, len(pts))
        cents = pts[rng.choice(len(pts), kk, replace=False)].copy()
        assign = np.zeros(len(pts), np.int64)
        for _ in range(n_iters):
            assign = _popcount_np(pts[:, None, :] ^ cents[None, :, :]).argmin(1)
            for c in range(kk):
                members = pts[assign == c]
                if len(members):
                    cents[c] = _majority(members)
        for c in range(kk):
            cid = len(nodes)
            nodes.append(cents[c])
            children.append([])
            word_of.append(-1)
            children[node_id].append(cid)
            cluster(member_idx[assign == c], level + 1, cid)

    cluster(np.arange(len(descs)), 0, 0)

    # leaves -> word ids in node order (DBoW3's createWords)
    words = []
    for nid in range(len(nodes)):
        if not children[nid] and nid != 0:
            word_of[nid] = len(words)
            words.append(nodes[nid])
    ch = np.full((len(nodes), k), -1, np.int32)
    for nid, cs in enumerate(children):
        ch[nid, : len(cs)] = cs
    return TreeVocabulary(
        nodes=np.stack(nodes),
        children=ch,
        word_id=np.asarray(word_of, np.int32),
        words=np.stack(words) if words else np.zeros((0, 32), np.uint8),
    )


def transform_tree(voc: TreeVocabulary, descriptors: np.ndarray) -> np.ndarray:
    """Greedy tree-walk quantization (DBoW3's approximate behaviour, host
    numpy; the device path is the exact flat :func:`transform`)."""
    descs = np.asarray(descriptors, np.uint8)
    out = np.empty(len(descs), np.int32)
    for i, d0 in enumerate(descs):
        nid = 0
        while True:
            cs = voc.children[nid]
            cs = cs[cs >= 0]
            if len(cs) == 0:
                break
            nid = int(cs[_popcount_np(voc.nodes[cs] ^ d0[None, :]).argmin()])
        out[i] = voc.word_id[nid]
    return out
