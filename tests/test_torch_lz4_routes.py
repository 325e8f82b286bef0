"""The shared-memory routes of the chained and dense lz4 encoders on the
CPU: csrc/lz4_chain.cu's capped best words (a serial model of the kernel's
capped walk against the port's plain words, built from the exact best of
every position), the parse over those words against tpuzip's chained C++
encoder, the dense encoder's u16 direct table (a serial model of its rule)
against the port's plain candidates and tpuzip's XLA encoder on 65,536-byte
rows, and both route choices as functions of (n, hash_log) alone.  The
kernels are held against these plain versions on the card by chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from tpuzip.codecs import lz4 as jlz4
from tpuzip.runtime import native
import chip_smoke
from tpuzip_torch.codecs.lz4 import hash_log as resolve_hash_log
from tpuzip_torch.kernels import lz4_chain, lz4_dense

XLA_ENCODE = jax.jit(jlz4.encode_batch, static_argnums=2)
N = 4096
CAPS = (16, 32, 64, 258)   # caps of the plain words; the kernel's is one


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (as in test_torch_lz4_chain.py: the plain
    versions' many small ops wait on the other workers' cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _edge_rows(cap: int):
    """chip_smoke's cap rows at `cap`, a run row and a b"ab" row (every
    position's first link reaches the row's end), and a row of 4 symbols."""
    rows, lens = chip_smoke.cap_rows(N, cap, 30 + cap)
    rng = np.random.default_rng(cap)
    runs = np.repeat(rng.integers(0, 256, N), rng.integers(1, 700, N))[:N]
    more = np.stack([runs, np.resize([97, 98], N), rng.integers(0, 4, N)])
    return (torch.from_numpy(np.concatenate([rows, more]).astype(np.uint8)),
            torch.from_numpy(np.concatenate([lens, np.full(3, N, np.int32)])))


def _capped_words(row, ln: int, prev, max_chain: int, cap: int) -> list:
    """A serial model of the best kernel's walk: the C++'s find_best with
    every extension capped at `cap`, stopping at the first candidate that
    reaches it (the word MARKED where that happens before length - 5)."""
    limit, lim = max(ln - 12, 0), ln - 5
    out = [0] * len(row)
    for p in range(limit):
        most = min(lim - p, cap)
        best, at, c, chain = 0, -1, prev[p], max_chain
        while c >= 0 and c < p and p - c <= 0xFFFF and chain > 0:
            if row[c + best] == row[p + best]:
                m = 0
                while m < most and row[c + m] == row[p + m]:
                    m += 1
                if m > best:
                    best, at = m, c
                    if m >= most:
                        break
            c, chain = prev[c], chain - 1
        marked = best >= cap and cap < lim - p
        out[p] = (lz4_chain.MARKED if marked
                  else 0 if at < 0 else best << 16 | (p - at))
    return out


@pytest.mark.parametrize("cap", CAPS)
def test_capped_words_equal_exact(cap):
    """The capped walk's words are the plain version's at every position
    (exact below the cap, MARKED from it on) on rows built to straddle the
    cap, on runs and on b"ab"; below the cap they carry _best_matches'
    exact best and link."""
    x, lens = _edge_rows(cap)
    prev = lz4_chain.lz4_chain_links_plain(x, lens, 16)
    words = lz4_chain.lz4_chain_best_plain(x, lens, prev, 8, cap)
    best, at = lz4_chain._best_matches(x, lens, prev, 8)
    for r in range(x.shape[0]):
        got = _capped_words(x[r].tolist(), int(lens[r]), prev[r].tolist(),
                            8, cap)
        assert got == words[r].tolist(), r
    plain = words != lz4_chain.MARKED
    assert torch.equal(torch.where(plain, words >> 16, 0),
                       torch.where(plain, best, 0).to(torch.int32))
    assert bool((best[~plain] >= cap).all())
    marks = (~plain).sum(1).tolist()
    assert marks[0] == 3 and all(marks[:6]), marks   # cap, cap + 1 twice


@pytest.mark.parametrize("max_chain", [2, 8, 64])
def test_parse_over_words_equals_native(max_chain):
    """The parse over the capped words (exact walks only where MARKED) is
    tpuzip's chained C++ encoder's stream, row by row, at each cap up to
    the kernel's (at 258 the rows' MARKED words all but vanish, and the
    words test holds that cap)."""
    assert native.available()
    assert lz4_chain.BEST_CAP in CAPS[:3]
    for cap in CAPS[:3]:
        x, lens = _edge_rows(cap)
        prev = lz4_chain.lz4_chain_links_plain(x, lens, 16)
        words = lz4_chain.lz4_chain_best_plain(x, lens, prev, max_chain, cap)
        comp, clens = lz4_chain.lz4_chain_parse_plain(x, lens, prev,
                                                      max_chain, words)
        ref, rlens = native.lz4_compress_batch(x.numpy(), lens.numpy(),
                                               max_chain=max_chain,
                                               hash_log=16)
        assert clens.tolist() == rlens.tolist(), cap
        for r, ln in enumerate(rlens):
            assert comp[r, :ln].numpy().tobytes() == ref[r, :ln].tobytes()


def test_farthest_repeat_of_a_staged_row():
    """A 65,536-byte row (chip_smoke.stage_edge_rows) takes its repeat
    65,523 back, the farthest such a row holds, as tpuzip's C++ does."""
    rows, lens = chip_smoke.stage_edge_rows(4)
    x, lens = torch.from_numpy(rows), torch.from_numpy(lens)
    comp, clens = lz4_chain.lz4_chain_encode_batch(x, lens, 16, 8)
    ref, rlens = native.lz4_compress_batch(rows, lens.numpy(), max_chain=8,
                                           hash_log=16)
    assert clens.tolist() == rlens.tolist()
    stream = comp[0, : clens[0]].numpy().tobytes()
    assert stream == ref[0, : rlens[0]].tobytes()
    assert chip_smoke.lz4_offsets(stream)[-1] == 65523


def _direct_u16(row, ln: int, hash_log: int) -> list:
    """A serial model of the shared route's table: 2^bits u16 slots holding
    position + 1 (0 empty), every position below length - 12 entered in
    order; a candidate kept where it lies at most 65,535 back and its 4
    bytes equal."""
    bits = lz4_dense.table_bits(hash_log)
    table = [0] * (1 << bits)
    limit = max(ln - 12, 0)
    seq = np.frombuffer(bytes(row) + bytes(3), np.uint8).astype(np.uint64)
    seq = seq[:-3] | seq[1:-2] << 8 | seq[2:-1] << 16 | seq[3:] << 24
    h = ((seq * 2654435761) & 0xFFFFFFFF) >> (32 - bits) if bits else \
        np.zeros_like(seq)
    seq, h = seq.tolist(), h.tolist()   # Python ints: a faster serial walk
    out = [-1] * len(row)
    for p in range(limit):
        c = int(table[h[p]]) - 1
        table[h[p]] = p + 1
        if c >= 0 and p - c <= 0xFFFF and seq[c] == seq[p]:
            out[p] = c
    return out


@pytest.mark.parametrize("hash_log", [4, 12, 15, 16])
def test_dense_words_equal_serial_model(hash_log):
    """The shared route's words: at each candidate, the match's length
    (the 4 bytes, then while the bytes agree before length - 5) below
    WORD_CAP, MARKED with the candidate's distance from WORD_CAP on (where
    WORD_CAP < length - 5 - p), 0 without a candidate; on rows that
    straddle the cap, runs and b"ab"."""
    cap = lz4_dense.WORD_CAP
    x, lens = _edge_rows(cap)
    words = lz4_dense.lz4_dense_words_plain(x, lens, hash_log)
    for r in range(x.shape[0]):
        row, ln = x[r].tolist(), int(lens[r])
        end = ln - 5
        cand = _direct_u16(row, ln, hash_log)
        want = [0] * len(row)
        for p, c in enumerate(cand):
            if c < 0:
                continue
            most, m = min(end - p, cap), 4
            while m < most and row[p + m] == row[c + m]:
                m += 1
            marked = m >= cap and cap < end - p
            want[p] = (lz4_dense.MARKED if marked else m << 16) | (p - c)
        assert words[r].tolist() == want, r
    assert bool((words < 0).any())


@pytest.mark.parametrize("hash_log", [0, 1, 12, 15, 16])
def test_direct_u16_rule_equals_xla(hash_log):
    """On two 65,536-byte rows (text, and chip_smoke's edge row), the u16
    direct table's candidates are the plain candidates, and the shared
    route's plain stream (its words, then the parse over them) is tpuzip's
    XLA encode_batch's."""
    text = np.frombuffer(chip_smoke.text_corpus(1 << 16, 7), np.uint8)
    edge, _ = chip_smoke.stage_edge_rows(5)
    rows = np.stack([text, edge[0]])
    lens = np.full(2, 1 << 16, np.int32)
    x, xl = torch.from_numpy(rows), torch.from_numpy(lens)
    cand = lz4_dense.lz4_dense_candidates_plain(x, xl, hash_log)
    for r in range(2):
        assert _direct_u16(rows[r].tolist(), 1 << 16, hash_log) == \
            cand[r].tolist(), r
    assert lz4_dense.encode_route(hash_log, 1 << 16) == "shared"
    comp, clens = lz4_dense.lz4_dense_encode_batch(x, xl, hash_log)
    ref, rlens = (np.asarray(a) for a in XLA_ENCODE(rows, lens, hash_log))
    assert clens.tolist() == rlens.tolist()
    for r in range(2):
        assert comp[r, : clens[r]].numpy().tobytes() == \
            ref[r, : rlens[r]].tobytes()


@pytest.mark.parametrize("n", [1, 2048, 65535, 65536, 65537, 1 << 17])
def test_dense_route_is_a_function_of_shape(n):
    """The dense encoder's route: shared for rows of at most 65,536 bytes
    at table_bits <= 16 (hash_log 0, 33 and up and negative ones hash to
    0), tiled for wider rows there, sorted at 17-32 bits at any width; the
    same for any batch."""
    for hash_log in range(-2, 42):
        bits = lz4_dense.table_bits(hash_log)
        want = ("sorted" if bits > 16 else "shared" if n <= 65536
                else "tiled")
        assert lz4_dense.encode_route(hash_log, n) == want, hash_log
        assert lz4_dense.encode_route(hash_log, n) == \
            lz4_dense.encode_route(hash_log, n)
    with pytest.raises(ValueError, match="shared"):
        lz4_dense.lz4_dense_words(torch.zeros((1, n), dtype=torch.uint8),
                                  torch.tensor([n], dtype=torch.int32), 17)


@pytest.mark.parametrize("n", [1, 2048, 65536, 65537, 1 << 17])
def test_chain_routes_are_a_function_of_shape(n):
    """The chained encoder's routes: links shared for rows of at most
    65,536 bytes at a resolved hash_log <= 16 (out-of-range ones are 16),
    tiled for wider rows there, sorted at 17-24; best staged for rows of at
    most 65,536 bytes."""
    for hash_log in range(0, 32):
        bits = resolve_hash_log(hash_log)
        want = ("sorted" if bits > 16 else "shared" if n <= 65536
                else "tiled", "staged" if n <= 65536 else "device")
        assert lz4_chain.routes(hash_log, n) == want, hash_log


def test_best_wrapper_checks_its_inputs():
    x, lens = _edge_rows(16)
    prev = lz4_chain.lz4_chain_links(x, lens, 16)
    with pytest.raises(ValueError, match="max_chain"):
        lz4_chain.lz4_chain_best(x, lens, prev, 0)
    with pytest.raises(ValueError, match="prev"):
        lz4_chain.lz4_chain_best(x, lens, prev[:, 1:], 8)
    with pytest.raises(ValueError, match="words"):
        lz4_chain.lz4_chain_parse(x, lens, prev, 8, prev[:, 1:])
    with pytest.raises(ValueError, match="words"):   # on every device
        lz4_chain.lz4_chain_parse(x, lens, prev, 8)
    with pytest.raises(TypeError):
        lz4_chain.lz4_chain_best(x.to(torch.int32), lens, prev, 8)
    before = lz4_chain.lz4_chain_best.launches
    words = lz4_chain.lz4_chain_best(x, lens, prev, 8)
    assert lz4_chain.lz4_chain_best.launches == before   # the plain one
    assert torch.equal(words, lz4_chain.lz4_chain_best_plain(
        x, lens, prev, 8, lz4_chain.BEST_CAP))
