"""The chunk decomposition that csrc/mtf.cu rests on, proved on the CPU: a
plain numpy replica of the kernel's three passes a direction, with the
chunk size C a parameter, held exact (tolerance 0) against the port's
plain MTF (``mtf_batch_plain``), tpuzip's masked XLA scan
(tpuzip/codecs/mtf.py) and tpuzip's Pallas kernel in interpret mode on the
valid prefixes.

Decode: pass 1 runs each chunk's steps from the identity list and keeps
the positions u_t it reads and its end list P_c in that frame; pass 2
walks a row's chunks, S_{c+1}[i] = S_c[P_c[i]]; pass 3 maps out[t] =
S_c[u_t].  Encode: pass 1 gives each symbol its index among the chunk's
symbols ordered by their last position, latest first (0xFF where the
chunk lacks it), walking back from the chunk's end; pass 2 composes the
ranks at each chunk's start; pass 3 runs each chunk's steps from them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuzip.codecs import mtf as jmtf
from tpuzip.kernels import mtf_scan as jscan
from tpuzip_torch.kernels import mtf_scan

ABSENT = 0xFF


def _rows(rng, n):
    """(9, n) blocks and lengths: text, random, constant, 4 symbols, Zipf,
    ragged, empty, length 1, and a row of whole permutations of the 256
    symbols (every 256-byte chunk holds all of them)."""
    text = np.frombuffer((b"abracadabra, the quick brown fox! " * 64)[:n],
                         np.uint8)
    zipf = 1.0 / np.arange(1, 257) ** 1.3
    perms = np.concatenate([rng.permutation(256)
                            for _ in range(-(-n // 256))])[:n]
    rows = [text, rng.integers(0, 256, n), np.full(n, 200),
            rng.integers(0, 4, n), rng.choice(256, n, p=zipf / zipf.sum()),
            rng.integers(0, 256, n), rng.integers(0, 256, n), text, perms]
    blocks = np.stack(rows).astype(np.uint8)
    lens = np.array([n, n, n, n, n, n // 3 + 5, 0, 1, n], np.int32)
    blocks[np.arange(n)[None, :] >= lens[:, None]] = 0
    return blocks, lens


def _split(blocks, lens, c):
    """The chunks of every row, row-major: (G, c) bytes, padded with 0, and
    each chunk's valid bytes (0 past its row's length)."""
    b, n = blocks.shape
    nc = -(-n // c)
    padded = np.zeros((b, nc * c), np.int64)
    padded[:, :n] = blocks
    valid = np.clip(lens[:, None] - c * np.arange(nc)[None, :], 0, c)
    return padded.reshape(b * nc, c), valid.reshape(-1), nc


def _scan(start, x, valid, decode):
    """Every chunk's steps at once from its rank_of table start (G, 256):
    -> (the outputs (G, c), rank_of at each chunk's end)."""
    g, c = x.shape
    rank_of = start.copy()
    out = np.zeros((g, c), np.int64)
    at = np.arange(g)
    for t in range(c):
        if decode:
            r = x[:, t]
            sym = np.argmax(rank_of == r[:, None], axis=1)
        else:
            sym = x[:, t]
            r = rank_of[at, sym]
        new = rank_of + (rank_of < r[:, None])
        new[at, sym] = 0
        live = valid > t
        rank_of = np.where(live[:, None], new, rank_of)
        out[:, t] = np.where(live, sym if decode else r, 0)
    return out, rank_of


def _last_index(chunk, n):
    """Encode's pass 1 on one chunk's first n bytes: each symbol's index in
    D_c, walking back from the end until all 256 are met."""
    index = np.full(256, ABSENT, np.int64)
    met = 0
    for p in range(n - 1, -1, -1):
        if met == 256:
            break
        if index[chunk[p]] == ABSENT:
            index[chunk[p]] = met
            met += 1
    return index


def _compose_encode(index, chunks):
    """Encode's pass 2 on one row: the ranks at the start of each of its
    first `chunks` chunks.  A symbol of D_c takes its index, any other
    |D_c| + its rank - the D_c symbols ranked before it; an index of 255
    reads as absent, which gives it the same rank."""
    s = np.arange(256)
    starts = []
    for k in range(chunks):
        starts.append(s)
        present = index[k] != ABSENT
        in_d = np.zeros(256, np.int64)
        in_d[s[present]] = 1                # by rank
        under = np.cumsum(in_d) - in_d      # D_c symbols ranked lower
        s = np.where(present, index[k], present.sum() + s - under[s])
    return starts


def chunked_encode(blocks, lens, c):
    b, n = blocks.shape
    x, valid, nc = _split(blocks, lens, c)
    index = np.stack([_last_index(ch, v) for ch, v in zip(x, valid)])
    start = np.tile(np.arange(256), (b * nc, 1))
    for row in range(b):
        chunks = -(-int(lens[row]) // c)
        for k, s in enumerate(_compose_encode(index[row * nc:], chunks)):
            start[row * nc + k] = s
    out, _ = _scan(start, x, valid, decode=False)
    return out.reshape(b, nc * c)[:, :n].astype(np.uint8)


def chunked_decode(blocks, lens, c):
    b, n = blocks.shape
    x, valid, nc = _split(blocks, lens, c)
    identity = np.tile(np.arange(256), (b * nc, 1))
    u, end_rank = _scan(identity, x, valid, decode=True)
    ends = np.argsort(end_rank, axis=1)     # P_c[rank] = u
    out = np.zeros_like(u)
    for row in range(b):
        s = np.arange(256)                  # S_c, the list
        for k in range(-(-int(lens[row]) // c)):
            g = row * nc + k
            out[g] = np.where(np.arange(c) < valid[g], s[u[g]], 0)
            s = s[ends[g]]
    return out.reshape(b, nc * c)[:, :n].astype(np.uint8)


def _plain(blocks, lens, decode=False):
    return mtf_scan.mtf_batch_plain(torch.from_numpy(blocks),
                                    torch.from_numpy(lens), decode).numpy()


@pytest.mark.parametrize("c", [1, 7, 64, 256, 600])
def test_chunked_passes_equal_the_whole_scan(rng, c):
    """Both directions against the plain scan and tpuzip's masked XLA scan
    on whole rows; 600 puts all 256 symbols and repeats in one chunk."""
    blocks, lens = _rows(rng, 1000)
    enc = chunked_encode(blocks, lens, c)
    np.testing.assert_array_equal(enc, _plain(blocks, lens))
    np.testing.assert_array_equal(
        enc, np.asarray(jax.jit(jmtf.encode_batch)(jnp.array(blocks),
                                                   jnp.array(lens))))
    dec = chunked_decode(enc, lens, c)
    np.testing.assert_array_equal(dec, _plain(enc, lens, decode=True))
    np.testing.assert_array_equal(dec, blocks)
    # a decode of bytes that no encode gave
    np.testing.assert_array_equal(chunked_decode(blocks, lens, c),
                                  _plain(blocks, lens, decode=True))


@pytest.mark.parametrize("decode", [False, True], ids=["encode", "decode"])
def test_chunked_passes_equal_the_pallas_kernel(rng, decode):
    """tpuzip's TPU kernel in interpret mode, on each row's valid prefix
    (it does not mask by length), at chunk size 64."""
    blocks, lens = _rows(rng, 512)
    got = (chunked_decode if decode else chunked_encode)(blocks, lens, 64)
    exp = np.asarray(jscan.mtf_batch(jnp.array(blocks), decode=decode,
                                     interpret=True))
    for i, m in enumerate(lens):
        np.testing.assert_array_equal(got[i, :m], exp[i, :m], err_msg=str(i))

