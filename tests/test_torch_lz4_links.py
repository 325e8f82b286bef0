"""The lz4 encoders' links past their shared routes on the CPU:
step-for-step replicas of csrc/lz4_shared.cuh's tiled links (split_row on
each tile of a row as on a row of its own under LZ4's 4-byte key, the
tiles' tables and first positions, then the carry over the tiles) and its
sorted links (each tile's keys h << 12 | p through the bitonic network,
the in-tile links and one entry a distinct hash, then the merge rounds of
the entries, a chunk at a time by merge path, the last round giving each
hash's first position in a tile its link), at tile and chunk widths small
enough that rows of 2-3 KiB span several tiles and chunks.  Each is held
against the plain links (kernels/lz4_links.py, tpuzip's C++ chain at 4..24
bits: tests/test_torch_lz4_chain.py) and, after the filter, against
tpuzip's XLA ``_candidates``; the words past 64 KiB against the plain
words; the containers of both encoders on these routes against tpuzip's;
the routes as a function of shape; and the CUDA wrappers refusing to fall
back to the plain versions.  chip_smoke.py holds the kernels against the
plain versions on the card at the kernels' widths."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpuzip.codecs import lz4 as jlz4
from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
import chip_smoke
import tpuzip_torch
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.kernels import lz4_chain, lz4_dense, lz4_links

HASH_MUL, MF_LIMIT = 2654435761, 12
P_BITS = 12                      # a sort key's bits of position
CLASSES, QUEUE, SCAN = 8, 32, 128
MESH1 = meshlib.make_mesh(1)
XLA_CANDIDATES = {}


def _key(row: np.ndarray, p: int, bits: int) -> int:
    """The hash of the 4 bytes at p (all inside the row's length)."""
    if bits == 0:
        return 0
    word = int.from_bytes(row[p : p + 4].tobytes(), "little")
    return (word * HASH_MUL % (1 << 32)) >> (32 - bits)


def _split_row(keys: list) -> tuple[list, list]:
    """split_row on positions 0..len(keys)-1 of hashes keys: warp h % 8's
    queue filled 32 entries at a time from scans of 128 positions and
    stepped through __match_any_sync's groups against the u16 table, scans
    inside a run of one hash emitted at once -> (prev, the table after:
    slot h the last position of hash h, + 1, or 0)."""
    limit = len(keys)
    prev = [-1] * limit
    table = {}
    queues = [[] for _ in range(CLASSES)]

    def step(entries):
        for lane, (p, h) in enumerate(entries):
            earlier = [q for q, g in entries[:lane] if g == h]
            prev[p] = earlier[-1] if earlier else table.get(h, 0) - 1
        for lane, (p, h) in enumerate(entries):
            if all(g != h for _, g in entries[lane + 1 :]):
                assert p + 1 <= 0xFFFF   # a u16 slot
                table[h] = p + 1

    last = 0
    for first in range(0, limit, SCAN):
        ps = list(range(first, first + SCAN))
        hs = [keys[p] if p < limit else 0 for p in ps]
        if first > 0 and first + SCAN <= limit and all(h == last
                                                       for h in hs):
            q = queues[last % CLASSES]
            if q:
                step(q)
                q.clear()
            table[last] = first + SCAN
            for p in ps:
                prev[p] = p - 1
            continue
        last = hs[-1]
        for k in range(SCAN // QUEUE):
            for p, h in zip(ps[QUEUE * k : QUEUE * (k + 1)],
                            hs[QUEUE * k : QUEUE * (k + 1)]):
                if p < limit:
                    queues[h % CLASSES].append((p, h))
            for q in queues:
                if len(q) >= QUEUE:
                    step(q[:QUEUE])
                    del q[:QUEUE]
    for q in queues:
        if q:
            step(q)
    return prev, table


def tiled_links(row: np.ndarray, ln: int, bits: int, tile: int) -> list:
    """links_tiled_kernel and links_carry_kernel under Key4 on one row:
    each tile's positions below the limit (length - 12) linked by the
    split_row replica as a row of their own, the keys read from the whole
    row (into the next tile), its table and, for each hash it holds, its
    first position; then each hash's tiles in order, the first position of
    each taking the last position of the hash in the tiles before."""
    n = len(row)
    limit = max(ln - MF_LIMIT, 0)
    prev = [-1] * n
    tiles = []
    for t0 in range(0, limit, tile):
        keys = [_key(row, t0 + p, bits) for p in range(min(limit - t0, tile))]
        got, table = _split_row(keys)
        first = {}
        for p, c in enumerate(got):
            prev[t0 + p] = -1 if c < 0 else t0 + c
            if c < 0:
                first[keys[p]] = p
        assert set(table) == set(first)
        tiles.append((t0, table, first))
    for h in sorted(set().union(*(f for _, _, f in tiles))):
        carried = -1
        for t0, table, first in tiles:
            if h in table:
                if carried >= 0:
                    prev[t0 + first[h]] = carried
                carried = t0 + table[h] - 1
    return prev


def _bitonic(keys: np.ndarray) -> np.ndarray:
    """links_sort_tile_kernel's network on keys (u64, a power of two of
    them), stage by stage: at (k, j) the pair (lo, lo + j) of each i,
    ascending where lo & k is 0, swapped where out of that order."""
    keys = keys.copy()
    size = len(keys)
    i = np.arange(size // 2)
    k = 2
    while k <= size:
        j = k >> 1
        while j > 0:
            lo = 2 * i - (i & (j - 1))
            hi = lo + j
            a, b = keys[lo], keys[hi]
            swap = (a > b) == ((lo & k) == 0)
            keys[lo[swap]], keys[hi[swap]] = b[swap], a[swap]
            j >>= 1
        k <<= 1
    return keys


def _merge_split(a: list, b: list, d: int) -> int:
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] < b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def sorted_links(row: np.ndarray, ln: int, bits: int, tile: int,
                 chunk: int, run: int) -> list:
    """links_sort_tile_kernel and the merge rounds of links_merge_kernel
    on one row, tiles of `tile` positions, chunks of `chunk` entries,
    `run` a thread: each tile's keys h << 12 | p sorted by the network
    (the whole tile's width, past the live keys the largest key; a tile of
    one hash is in order already and skips it), a key's
    link the key before it where the
    hash is the same; an entry h << 32 | (t0 + d) a distinct hash, with its
    first and last position in the tile; then rounds of pairwise merges
    of runs of 1, 2, 4, ... tiles, each chunk split by merge path, a
    thread's part merged from its own split, and in the last round each
    entry whose predecessor has its hash (the chunk's first: the larger of
    the keys before its split) links its first position to that entry's
    last."""
    n = len(row)
    limit = max(ln - MF_LIMIT, 0)
    tiles = -(-n // tile)
    prev = [-1] * n
    ents, firsts, lasts, counts = {}, {}, {}, []
    for t in range(tiles):
        t0 = t * tile
        live = min(max(limit - t0, 0), min(tile, n - t0))
        if not live:
            counts.append(0)
            continue
        assert tile & (tile - 1) == 0   # the network's width, the tile's
        keys = np.full(tile, np.iinfo(np.uint64).max, np.uint64)
        keys[:live] = [_key(row, t0 + k, bits) << P_BITS | k
                       for k in range(live)]
        if len({int(v) >> P_BITS for v in keys[:live]}) > 1:
            keys = _bitonic(keys)   # a tile of one hash skips the network
        keys = [int(v) for v in keys[:live]]
        d = -1
        for i, key in enumerate(keys):
            h, p = key >> P_BITS, key & ((1 << P_BITS) - 1)
            if i == 0 or keys[i - 1] >> P_BITS != h:
                d += 1
                ents[t0 + d] = h << 32 | (t0 + d)
                firsts[t0 + d] = p
            else:
                prev[t0 + p] = t0 + (keys[i - 1] & ((1 << P_BITS) - 1))
            if i + 1 == live or keys[i + 1] >> P_BITS != h:
                lasts[t0 + d] = p
        counts.append(d + 1)
    runs = {t: [ents[t * tile + d] for d in range(counts[t])]
            for t in range(tiles)}
    width = 1
    while width < tiles:
        last = 2 * width >= tiles
        merged_runs = {}
        for ta in range(0, tiles, 2 * width):
            a, b = runs[ta], runs.get(ta + width, [])
            out = []
            for d0 in range(0, len(a) + len(b), chunk):
                d1 = min(d0 + chunk, len(a) + len(b))
                a0, a1 = _merge_split(a, b, d0), _merge_split(a, b, d1)
                sa, sb = a[a0:a1], b[d0 - a0 : d1 - a1]
                part = []
                for dt in range(0, d1 - d0, run):
                    i = _merge_split(sa, sb, dt)
                    j = dt - i
                    for _ in range(min(run, d1 - d0 - dt)):
                        if j >= len(sb) or (i < len(sa) and sa[i] < sb[j]):
                            part.append(sa[i])
                            i += 1
                        else:
                            part.append(sb[j])
                            j += 1
                if last:
                    for k, cur in enumerate(part):
                        if k:
                            pre = part[k - 1]
                        elif a0 or d0 - a0:
                            pre = max(a[a0 - 1] if a0 else 0,
                                      b[d0 - a0 - 1] if d0 - a0 else 0)
                        else:
                            continue
                        if pre >> 32 == cur >> 32:
                            e, f = cur & 0xFFFFFFFF, pre & 0xFFFFFFFF
                            prev[e - e % tile + firsts[e]] = \
                                f - f % tile + lasts[f]
                out += part
            merged_runs[ta] = out
        runs = merged_runs
        width *= 2
    return prev


def _rows(n: int, seed: int):
    """(8, n) u8 rows and lengths: text, zeros, b"ab", random bytes, text
    with random bytes past a length of n - 700, text cut to 13 and to 0
    bytes, and a row whose 4-byte-aligned 4-grams share the top 16 bits of
    h at 24 and 32 bits (chip_smoke.top_bits_rows)."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(chip_smoke.text_corpus(n, seed), np.uint8)
    rows = np.stack([text, np.zeros(n, np.uint8),
                     np.resize(np.frombuffer(b"ab", np.uint8), n),
                     rng.integers(0, 256, n, np.uint8), text, text, text,
                     chip_smoke.top_bits_rows(1, n, seed)[0]])
    lens = np.array([n, n, n - 5, n, n - 700, 13, 0, n], np.int32)
    rows[4, n - 700:] = rng.integers(0, 256, 700, np.uint8)
    rows[5:7, 13:] = 0
    return rows, lens


def _candidates(rows: np.ndarray, lens: np.ndarray, hash_log: int):
    """tpuzip's XLA candidates (jitted once a shape and hash_log)."""
    key = (rows.shape, hash_log)
    if key not in XLA_CANDIDATES:
        XLA_CANDIDATES[key] = jax.jit(jax.vmap(
            lambda b, n: jlz4._candidates(b, n, hash_log)))
    return np.asarray(XLA_CANDIDATES[key](rows, lens))


def _held(rows, lens, bits, got) -> None:
    """got (the replica's links of each row) equals the plain links (the
    C++ chain's at 4..24 bits) and, filtered, XLA's candidates."""
    x, xl = torch.from_numpy(rows), torch.from_numpy(lens)
    want = lz4_links.lz4_links_plain(x, xl, bits)
    if 4 <= bits <= 24:
        assert torch.equal(want, lz4_chain.lz4_chain_links_plain(x, xl, bits))
    for r in range(len(rows)):
        assert got[r] == want[r].tolist(), r
    cand = lz4_dense._filter(x, xl, torch.tensor(got, dtype=torch.int32))
    np.testing.assert_array_equal(cand.numpy(),
                                  _candidates(rows, lens, bits))


@pytest.mark.parametrize("bits", [4, 12, 16])
def test_tiled_replica_equals_plain(bits):
    """The tiled replica, tiles of 700 positions on rows of 2,600 bytes
    (four tiles, the last one short), on every row kind."""
    rows, lens = _rows(2600, bits)
    got = [tiled_links(rows[r], int(lens[r]), bits, 700)
           for r in range(len(rows))]
    _held(rows, lens, bits, got)


@pytest.mark.parametrize("bits", [17, 20, 24, 32])
def test_sorted_replica_equals_plain(bits):
    """The sorted replica, tiles of 256 positions (11 of them, the last one
    short: three merge rounds and a fourth with one run alone), chunks of
    64 entries, 8 a thread, on every row kind; the top-bits row's aligned
    4-grams share their hash's top 16 bits, and its links reach back."""
    rows, lens = _rows(2700, bits)
    got = [sorted_links(rows[r], int(lens[r]), bits, 256, 64, 8)
           for r in range(len(rows))]
    _held(rows, lens, bits, got)
    top = [p - q for p, q in enumerate(got[-1]) if q >= 0]
    assert max(top) > 256   # a link across the tiles


def test_sorted_replica_at_the_kernel_widths():
    """The sorted replica at the kernel's SORT_TILE, MERGE_CHUNK and run on
    text over three tiles and a bit of a fourth."""
    rows, lens = _rows(3 * lz4_links.SORT_TILE + 500, 3)
    rows, lens = rows[[0, 3, 7]], lens[[0, 3, 7]]
    got = [sorted_links(rows[r], int(lens[r]), 20, lz4_links.SORT_TILE,
                        2048, 8) for r in range(len(rows))]
    _held(rows, lens, 20, got)


def test_words_past_64_kib_equal_plain():
    """Rows of 128 KiB (chip_smoke.far_rows: repeats 65,533 to 70,000
    back): the words from the links at 16 bits (the tiled route) and at
    20 (the sorted one) equal the plain words, the repeats past 65,535
    back refused by the filter (their streams are XLA's in
    tests/test_torch_lz4_dense.py::test_far_repeats_equal_xla)."""
    rows, lens = chip_smoke.far_rows(chip_smoke.SEED + 9)
    rows, lens = rows[[0, 2, 3]], lens[[0, 2, 3]]
    x, xl = torch.from_numpy(rows), torch.from_numpy(lens)
    for hash_log in (16, 20):
        assert lz4_dense.encode_route(hash_log, x.shape[1]) == \
            ("tiled" if hash_log == 16 else "sorted")
        prev = lz4_links.lz4_links_plain(x, xl, hash_log)
        words = lz4_dense.lz4_dense_words_links(x, xl, prev)
        assert torch.equal(words,
                           lz4_dense.lz4_dense_words_plain(x, xl, hash_log))
        far = (words & 0xFFFF).max(dim=1).values.tolist()
        assert far[:2] == [65533, 65535] and far[2] < 65533


def _data(nbytes: int) -> bytes:
    text = chip_smoke.text_corpus(nbytes - 3000, 23)
    return text[: nbytes // 2] + bytes(1500) + b"ab" * 750 + \
        text[nbytes // 2 :]


@pytest.mark.parametrize("hash_log,block_size,device_encode,max_chain", [
    (17, 4096, True, 1), (20, 4096, True, 1), (24, 4096, True, 1),
    (32, 4096, True, 1), (16, 131072, True, 1), (20, 4096, False, 8),
    (16, 131072, False, 8)])
def test_container_identical(hash_log, block_size, device_encode,
                             max_chain):
    """compress on the tiled and sorted routes (the device encoder at
    hash_log 17-32 and at 128 KiB blocks, a block of 70,000 bytes; the
    chained one at 20 and at 128 KiB blocks) against tpuzip's container;
    tpuzip decodes the port's, and the port tpuzip's at 4 KiB blocks (its
    plain decoder takes a Python step a sequence: at 128 KiB the card's
    decoder reads these blocks in chip_smoke's lz4_wide)."""
    cfg = Config()
    cfg.codec.lz4.device_encode = device_encode
    cfg.codec.lz4.hash_log = hash_log
    cfg.codec.lz4.max_chain = max_chain
    data = _data(70_000 if block_size > 65536 else 9000)
    n = min(block_size, len(data))
    route = (lz4_dense.encode_route(hash_log, n) if device_encode
             else lz4_chain.routes(hash_log, n)[0])
    assert route == ("sorted" if hash_log > 16 else "tiled")
    mine = tpuzip_torch.compress(
        data, block_size=block_size, device="cpu",
        config=config_from_dict(dataclasses.asdict(cfg)))
    ref = jrun.compress(data, block_size=block_size, mesh=MESH1, config=cfg)
    assert mine == ref
    assert jrun.decompress(mine, mesh=MESH1) == data
    if block_size <= 65536:
        assert tpuzip_torch.decompress(ref, device="cpu") == data


@pytest.mark.parametrize("bits,n,want", [
    (0, 65536, "shared"), (16, 65536, "shared"), (16, 1, "shared"),
    (0, 65537, "tiled"), (4, 1 << 17, "tiled"), (16, 1 << 23, "tiled"),
    (17, 1, "sorted"), (20, 65536, "sorted"), (24, 1 << 17, "sorted"),
    (32, 1 << 23, "sorted")])
def test_links_route_is_a_function_of_shape(bits, n, want):
    """The links' route: the encoder's shared kernel for rows of at most
    65,536 bytes at at most 16 bits, tiled for wider rows there, sorted
    past 16 bits at any width; the encoders' routes agree with it."""
    assert lz4_links.links_route(bits, n) == want
    assert lz4_dense.encode_route(bits, n) == want
    if 4 <= bits <= 24:
        assert lz4_chain.routes(bits, n)[0] == want
    assert lz4_links.SORT_TILE <= 0xFFFF and lz4_links.LINK_TILE < 0xFFFF


class _OnCuda:
    """What the wrappers read of a CUDA tensor, where no GPU is usable."""

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.dtype, self.shape = t.dtype, t.shape
        self.device = torch.device("cuda")

    def dim(self):
        return self.t.dim()

    def is_contiguous(self):
        return True

    def contiguous(self):
        return self

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.mark.parametrize("call", ["tiled", "sorted", "words_links",
                                  "dense_sorted", "chain_tiled"])
def test_cuda_wrappers_raise_without_gpu(monkeypatch, call):
    """A CUDA tensor goes to the kernels on every new route and raises
    without a GPU: the plain versions never run for it, and no launch is
    counted."""
    def refuse(*args, **kw):
        raise AssertionError("a plain version ran for a CUDA tensor")

    for mod, name in ((lz4_links, "lz4_links_plain"),
                      (lz4_dense, "lz4_dense_words_links_plain"),
                      (lz4_dense, "lz4_dense_words_parse_plain"),
                      (lz4_chain, "lz4_chain_links_plain")):
        monkeypatch.setattr(mod, name, refuse)
    n = 1 << 17 if call in ("tiled", "chain_tiled") else 2048
    x = _OnCuda(torch.zeros((2, n), dtype=torch.uint8))
    xl = _OnCuda(torch.full((2,), n, dtype=torch.int32))
    counters = (lz4_links.lz4_links_tiled, lz4_links.lz4_links_sorted,
                lz4_dense.lz4_dense_words_links, lz4_chain.lz4_chain_links)
    before = [f.launches for f in counters]
    run = {"tiled": lambda: lz4_links.lz4_links_tiled(x, xl, 16),
           "sorted": lambda: lz4_links.lz4_links_sorted(x, xl, 20),
           "words_links": lambda: lz4_dense.lz4_dense_words_links(
               x, xl, _OnCuda(torch.zeros((2, n), dtype=torch.int32))),
           "dense_sorted": lambda: lz4_dense.lz4_dense_encode_batch(
               x, xl, 20),
           "chain_tiled": lambda: lz4_chain.lz4_chain_links(x, xl, 16)}
    with pytest.raises((RuntimeError, AssertionError),
                       match="CUDA|cuda|GPU|driver|nvcc"):
        run[call]()
    assert [f.launches for f in counters] == before
