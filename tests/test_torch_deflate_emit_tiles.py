"""The tiled forms of csrc/deflate_encode.cu's histograms and emit (the
device rule's rows at every width, and every row past 64 KiB) replicated
step for step in Python: deflate_hist_kernel (a CTA a tile of tokens, a
histogram a warp, the copies' sums added into the row's counts), the tile
offsets (deflate_emit_sums_kernel's bits a tile, deflate_emit_scan_kernel's
scan over a row's tiles from the header's end, its EOB and length) and
deflate_emit_tiles_kernel (a thread a run of consecutive tokens at its
offset by a block scan, its fields gathered in a 64-bit register and
written a word at a time: the first word it touches and its last partial
word OR-ed, the words between stored).  At tile widths of 1 to 4,096
tokens, on rows of 300 B to 48 KiB at each byte skip of the row's first
byte in its word, held against deflate_emit_plain in both orders, against
tpuzip's deflate_batch (JAX on the CPU) and read back by zlib.  The CUDA
kernels are held against deflate_emit_plain on the card by chip_smoke.py."""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuzip.codecs import deflate as jdef
from tpuzip_torch.kernels import deflate_coder as dc

N = 48 << 10      # the rows' width: tpuzip's vmapped stages compile a shape
with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()
# (threads a tile, tokens a thread's run): tiles of 1 to 4,096 tokens; the
# kernels' (256, 16) last
SHAPES = ((1, 1), (2, 3), (32, 1), (33, 5), (64, 16), (256, 16))
WORD = 32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here, as in the deflate tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows():
    """6 rows of N bytes and their lengths: text, random bytes, zeros,
    b"ab", and text rows of 300 and 4,097 bytes."""
    rng = np.random.default_rng(22)
    text = np.frombuffer((TEXT * (2 * N // len(TEXT) + 2))[: 2 * N], np.uint8)
    rows = [text[:N], rng.integers(0, 256, N, dtype=np.uint8),
            np.zeros(N, np.uint8), np.resize(np.frombuffer(b"ab", np.uint8), N),
            text[N:], text[N // 2 : N // 2 + N]]
    lens = np.array([N, 20000, N, 10000, 300, 4097], np.int32)
    x = np.stack(rows)
    x[np.arange(N)[None, :] >= lens[:, None]] = 0
    return x, lens


X, LENS = _rows()


def _tokens(greedy: bool):
    """Each row's tokens (lists): the device rule's greedy parse at
    max_chain 1, or the C++ rule's lazy parse at max_chain 8."""
    xt, lt = torch.from_numpy(X), torch.from_numpy(LENS)
    prev = dc.deflate_links_plain(xt, lt)
    tok, nt = dc.deflate_parse_plain(xt, lt, prev, 1 if greedy else 8,
                                     greedy=greedy)
    return [tok[r, : int(nt[r])].tolist() for r in range(len(X))]


TOKENS = {True: _tokens(True), False: _tokens(False)}


def _symbols(tokens):
    """(literal/length symbol, distance symbol or -1) of each token."""
    tok = torch.tensor(tokens, dtype=torch.int64)
    lit, lc, dcode = dc._token_codes(tok)
    sym = torch.where(lit, tok, 257 + lc).numpy()
    return sym, torch.where(lit, -1, dcode).numpy()


def hist_replica(tokens, threads: int, run: int) -> np.ndarray:
    """deflate_hist_kernel over one row: 320 counts (literal/length
    0..287, distance at 288..). Tiles of threads x run tokens; in a tile,
    thread t loads tokens j * threads + t (j < run) and counts them into
    its warp's copy; each tile's copies summed, then added to the row's."""
    tile = threads * run
    warps = (threads + WORD - 1) // WORD
    sym, dsym = _symbols(tokens)
    ntiles = (len(tokens) + tile - 1) // tile   # the rest exit at once
    o = np.arange(len(tokens))
    copy = (o // tile) * warps + ((o % tile) % threads) // WORD
    m = dsym >= 0
    keys = np.concatenate([copy * 320 + sym, copy[m] * 320 + 288 + dsym[m]])
    copies = np.bincount(keys, minlength=ntiles * warps * 320).reshape(
        ntiles, warps, 320)
    return copies.sum(1).sum(0) if ntiles else np.zeros(320, np.int64)


def _fields(tokens, llen, dlen):
    """Each token's two fields, (value, bits) each (bits 0 for a
    literal's second), as the kernels' token_fields gives them."""
    lcode = dc._reversed_codes(llen)
    dcode = dc._reversed_codes(dlen)
    out = []
    for t in tokens:
        if t < 256:
            out.append(((lcode[t], llen[t]), (0, 0)))
            continue
        ln, d = t >> dc.MATCH_SHIFT, t & 0xFFFF
        lc, dcd = dc.len_code(ln), dc.dist_code(d)
        out.append(((lcode[257 + lc] | (ln - dc.LEN_BASE[lc]) << llen[257 + lc],
                     llen[257 + lc] + dc.LEN_EXTRA[lc]),
                    (dcode[dcd] | (d - dc.DIST_BASE[dcd]) << dlen[dcd],
                     dlen[dcd] + dc.DIST_EXTRA[dcd])))
    return out


def emit_replica(tokens, order: str, threads: int, run: int, skip: int,
                 rng) -> tuple:
    """One row's stream by the tiled route, step for step: the tables from
    hist_replica's counts; the header's bytes at byte skip of the row's
    first word (the tables kernel's byte stores); each tile's bits (its
    threads' runs summed); the row's scan of them from skip * 8 + the
    header's bits, then the EOB; then every thread's run, in an order of
    the rng (the CTAs and threads run in any order), written through a
    64-bit accumulator: the first flushed word and the last partial word
    OR-ed, the words between stored, each of those asserted to hold no bit
    before its store.  Returns (the stream's bytes, {"bounds": the tile
    boundaries' bit offsets mod 32, "stored": the words the runs stored,
    "ends": the runs whose last field ends a word})."""
    tile = threads * run
    counts = hist_replica(tokens, threads, run)
    llen, dlen, head = dc.freq_tables(counts[:286].tolist(),
                                      counts[288:318].tolist(), order)
    cap = 2 * N + 4096
    nwords = (skip + cap + 3) // 4
    words = np.zeros(nwords + 1, np.uint64)   # 32-bit words, in u64
    header = dc._pack_fields(torch.tensor([v for v, _ in head]),
                             torch.tensor([b for _, b in head])).numpy()
    hbits = sum(b for _, b in head)
    raw = words.astype(np.uint32).view(np.uint8)
    raw[skip : skip + len(header)] = header
    words = raw.view(np.uint32).astype(np.uint64)

    def put(pos, v, nb):                      # the scan kernel's put()
        if not nb:
            return
        w, sh = pos >> 5, pos & 31
        if w < nwords:
            words[w] |= np.uint64((v << sh) & 0xFFFFFFFF)
        if sh + nb > 32 and w + 1 < nwords:
            words[w + 1] |= np.uint64(v >> (32 - sh))

    fields = _fields(tokens, llen, dlen)
    bits = [a[1] + b[1] for a, b in fields]
    ntiles = (len(tokens) + tile - 1) // tile
    # the sums kernel: each tile's bits
    sums = [sum(bits[k * tile : (k + 1) * tile]) for k in range(ntiles)]
    # the scan kernel: each tile's first bit, then the EOB and the length
    first, base = [], skip * 8 + hbits
    for k in range(ntiles):
        first.append(base)
        base += sums[k]
    eob = dc._reversed_codes(llen)[256]
    put(base, eob, llen[256])
    length = (base - skip * 8 + llen[256] + 7) // 8
    # the tiles kernel: a thread's run at its offset within its tile
    runs = []
    for k in range(ntiles):
        pos = first[k]
        for t in range(threads):
            lo = k * tile + t * run
            hi = min(lo + run, (k + 1) * tile, len(tokens))
            if lo < hi:
                runs.append((pos, lo, hi))
                pos += sum(bits[lo:hi])
    stats = {"bounds": {f % 32 for f in first[1:]}, "stored": 0, "ends": 0}
    for i in rng.permutation(len(runs)):
        pos, lo, hi = runs[i]
        w, fill, acc, firstw = pos >> 5, pos & 31, 0, True
        for t in range(lo, hi):
            for v, nb in fields[t]:
                acc |= v << fill
                fill += nb
                if fill >= 32:
                    if w < nwords:
                        if not firstw:
                            assert words[w] == 0, "a stored word held bits"
                            stats["stored"] += 1
                        words[w] |= np.uint64(acc & 0xFFFFFFFF)
                    firstw = False
                    acc >>= 32
                    fill -= 32
                    w += 1
        if fill and w < nwords:
            words[w] |= np.uint64(acc & 0xFFFFFFFF)
        stats["ends"] += fill == 0
    out = words.astype(np.uint32).view(np.uint8)[skip : skip + length]
    return out.tobytes(), stats


@functools.cache
def _plain(r: int, greedy: bool, order: str) -> bytes:
    tokens = TOKENS[greedy][r]
    xt, lt = torch.from_numpy(X[r : r + 1]), torch.from_numpy(LENS[r : r + 1])
    tok = torch.zeros((1, N), dtype=torch.int32)
    tok[0, : len(tokens)] = torch.tensor(tokens, dtype=torch.int32)
    comp, clens = dc.deflate_emit_plain(
        xt, lt, tok, torch.tensor([len(tokens)], dtype=torch.int32), 0, order)
    return comp[0, : int(clens[0])].numpy().tobytes()


@pytest.mark.parametrize("threads,run", SHAPES)
def test_hist_replica_counts_every_token(threads, run):
    """The tiled histograms equal the row's counts (token_histograms),
    whatever the tile: tiles past the tokens add nothing."""
    for greedy in (True, False):
        for tokens in TOKENS[greedy]:
            lf, df = dc.token_histograms(tokens)
            counts = hist_replica(tokens, threads, run)
            assert counts[:286].tolist() == lf
            assert counts[288:318].tolist() == df
            assert not counts[286:288].any() and not counts[318:].any()


@pytest.mark.parametrize("threads,run", SHAPES)
def test_emit_replica_equals_plain_emit(threads, run):
    """The tiled emit's stream equals deflate_emit_plain's, in both orders
    (the C++ rule's on its lazy tokens, the device rule's on its greedy
    ones), at every byte skip, and zlib reads it back; the words between
    a run's first and last are each stored by one run alone."""
    rng = np.random.default_rng(threads * 100 + run)
    seen = {"bounds": set(), "stored": 0, "ends": 0}
    for order, greedy in (("tuple", True), ("std", False)):
        for r, tokens in enumerate(TOKENS[greedy]):
            skip = (r + threads) % 4
            got, stats = emit_replica(tokens, order, threads, run, skip, rng)
            seen["bounds"] |= stats["bounds"]
            seen["stored"] += stats["stored"]
            seen["ends"] += stats["ends"]
            assert got == _plain(r, greedy, order), (order, r, skip)
            assert zlib.decompress(got, -15) == X[r, : LENS[r]].tobytes()
    # tile boundaries inside a word, and on one where the rows hold
    # hundreds of tiles; runs whose last field ends a word; runs of 5
    # tokens or more store whole words
    assert seen["bounds"] - {0}, seen
    assert 0 in seen["bounds"] or threads * run > 1024, seen
    assert seen["ends"] > 0 and (seen["stored"] > 0 or run < 5), seen


def test_emit_replica_equals_deflate_batch():
    """The device rule's tiled stream at the kernels' shape (tiles of
    4,096 tokens, runs of 16) equals tpuzip's deflate_batch, row by row,
    and tpuzip's length; an empty row too (one EOB)."""
    x = np.concatenate([X, np.zeros((1, N), np.uint8)])
    lens = np.concatenate([LENS, np.zeros(1, np.int32)])
    jc, jl = jdef.deflate_batch(jnp.asarray(x), jnp.asarray(lens))
    jc, jl = np.asarray(jc), np.asarray(jl)
    rng = np.random.default_rng(3)
    for r, tokens in enumerate(TOKENS[True] + [[]]):
        got, _ = emit_replica(tokens, "tuple", 256, 16, r % 4, rng)
        assert len(got) == jl[r]
        assert got == jc[r, : jl[r]].tobytes(), r


def test_emit_replica_one_token():
    """Rows of one token (a literal; the only match of b"aaaa"), in a tile
    of one token and in the kernels' tiles, at each byte skip."""
    rng = np.random.default_rng(9)
    for tokens, raw in (([97], b"a"), ([97, 3 << 16 | 1], b"aaaa")):
        for order in ("tuple", "std"):
            want = dc._emit_row(raw, tokens, 0, order)
            for threads, run in ((1, 1), (256, 16)):
                for skip in range(4):
                    got, _ = emit_replica(tokens, order, threads, run, skip,
                                          rng)
                    assert got == want
                    assert zlib.decompress(got, -15) == raw
