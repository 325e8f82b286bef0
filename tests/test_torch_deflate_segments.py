"""The deflate device rule's greedy parse in segments and the links' tiled
route on the CPU: step-for-step replicas of csrc/deflate_encode.cu's
segment kernels (the maps: each segment taken backward 32 positions a
window, a literal run resolved at once to the next match start, the links
inside a window by pointer jumping, the values ahead in a ring; the
chain: one lookup a segment from the row's start; the emit: each
segment's true path from its entry, 32 positions a window, marked by
doubling) and of its tiled links
(tests/test_torch_deflate_links.py's split_row replica on each tile as on
a row, the tiles' tables and first positions, then the carry over the
tiles), at small segment and tile widths, held against
deflate_parse_plain(greedy=True) and deflate_links_plain.  The rows are
those a shortcut would get wrong: zero rows and rows of period 258 (a walk
from a segment's start never meets the true path), matches that end at a
segment's end and 257 past it, lengths that end inside the last segment
or in a tile's last bytes, hashes last seen one or two tiles back or only
in the first tile.  The plain greedy parse is tpuzip's lz77_stage
(test_torch_deflate_xla.py holds it so on the rows that the replica takes
here too); chip_smoke.py holds the kernels against the plain versions on
the card, on the same rows (segment_rows, tile_rows) at the kernels'
widths."""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_deflate_links import _split_row
from test_torch_deflate_xla import _rows as xla_rows
from tpuzip_torch.kernels import deflate_coder as dc

ENTRIES = dc.MAX_MATCH           # where a token from before a segment lands
RING = 512                       # a maps warp's values ahead of its window
HASH_MUL, HASH_BITS = 2654435761, 15


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here, as in the deflate tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _best_at(x: torch.Tensor, xl: torch.Tensor) -> list:
    """best_at of every row as the best kernel writes it at max_chain 1:
    best << 16 | distance where there is a match, else 0."""
    best, at = dc._best_matches(x, xl, dc.deflate_links_plain(x, xl), 1)
    p = torch.arange(x.shape[1])[None, :]
    return torch.where(best > 0, best << 16 | (p - at), 0).tolist()


def _maps(ba: list, ln: int, seg: int) -> list:
    """deflate_segment_maps_kernel on one row: for each segment below the
    length, the value of each entry (count << 16 | the exit's offset past
    the segment's end).  A warp takes the segment's positions backward, 32
    a window: a match start's value is its next's, one token more; a
    literal's is the next match start's in the window, a token a literal
    more, or, where the run leaves the window, the value past it; a value
    past the window is read from a ring of RING values, one inside it is
    a later lane's, and those links resolve by pointer jumping over the
    window's lanes, in at most five rounds."""
    maps = []
    for s0 in range(0, ln, seg):
        end = min(seg, ln - s0)
        at_end = max(end - seg, 0)
        ring = [None] * RING

        def past(x):   # the value at x, past the window (from the ring)
            pos, val = ring[x % RING]
            assert pos == x          # the ring still holds it
            return val

        m = [0] * ENTRIES
        for w in range((end - 1) & ~31, -1, -32):
            b = [ba[s0 + i] >> 16 if i < end else 0
                 for i in range(w, w + 32)]
            starts = [w + lane < end and b[lane] >= dc.MIN_MATCH
                      for lane in range(32)]
            st, ptr = [0] * 32, list(range(32))
            for lane in range(32):
                i = w + lane
                if i >= end:
                    continue
                later = [k for k in range(lane + 1, 32) if starts[k]]
                if starts[lane]:
                    nx = i + b[lane]
                    assert b[lane] <= ENTRIES and s0 + nx <= ln
                    if nx >= end:
                        st[lane] = 1 << 16 | max(nx - seg, 0)
                    elif nx >= w + 32:
                        st[lane] = past(nx) + (1 << 16)
                    else:
                        st[lane], ptr[lane] = 1, nx - w
                elif later:
                    st[lane], ptr[lane] = later[0] - lane, later[0]
                elif w + 32 >= end:
                    st[lane] = (end - i) << 16 | at_end
                else:
                    st[lane] = past(w + 32) + ((w + 32 - i) << 16)
            rounds = 0
            while any(p != lane for lane, p in enumerate(ptr)):
                rounds += 1
                ts, tp = [st[p] for p in ptr], [ptr[p] for p in ptr]
                for lane in range(32):
                    if ptr[lane] == lane:
                        continue
                    if tp[lane] == ptr[lane]:   # the target is resolved
                        st[lane], ptr[lane] = ts[lane] + (st[lane] << 16), lane
                    else:
                        st[lane], ptr[lane] = st[lane] + ts[lane], tp[lane]
            assert rounds <= 5
            for lane in range(min(32, end - w)):
                i = w + lane
                assert st[lane] >> 16 <= seg and st[lane] & 0xFFFF < ENTRIES
                ring[i % RING] = (i, st[lane])
                if i < ENTRIES:
                    m[i] = st[lane]
        maps.append(m)
    return maps


def _chain(maps: list, seg: int) -> tuple[list, int]:
    """deflate_segment_chain_kernel on one row: each segment's true entry
    and first token, and the row's tokens."""
    segs, e, t = [], 0, 0
    for k, m in enumerate(maps):
        assert 0 <= e < ENTRIES
        segs.append((k * seg + e, t))
        t += m[e] >> 16
        e = m[e] & 0xFFFF
    return segs, t


def _emit(row: np.ndarray, ba: list, ln: int, seg: int, segs: list,
          n: int) -> list:
    """deflate_segment_emit_kernel on one row: each segment's true path
    from its entry, 32 positions a window; the path's positions in a
    window marked from its entry by doubling (each round the marked lanes'
    2^r-th successors inside the window, r < 5), each a token at its rank,
    a match as best_at, a literal as its byte; the last one's next the
    next window's entry."""
    tok = [0] * n
    for k, (p, t) in enumerate(segs):
        end = min((k + 1) * seg, ln)
        while p < end:
            w = p & ~31
            nx = [q + (ba[q] >> 16 if q < end and ba[q] >> 16 >= dc.MIN_MATCH
                       else 1) for q in range(w, w + 32)]
            jump = [x - w if x < min(end, w + 32) else 32 for x in nx]
            mask = 1 << (p - w)
            for r in range(5):
                marked = mask   # the reduce-or reads the round's start
                for lane in range(32):
                    if marked >> lane & 1 and jump[lane] < 32:
                        mask |= 1 << jump[lane]
                if r < 4:
                    jump = [jump[j] if j < 32 else j for j in jump]
            path = [lane for lane in range(32) if mask >> lane & 1]
            for rank, lane in enumerate(path):
                q = w + lane
                assert q < end
                tok[t + rank] = (ba[q] if ba[q] >> 16 >= dc.MIN_MATCH
                                 else int(row[q]))
            t += len(path)
            p = nx[path[-1]]
            assert p >= min(end, w + 32)   # the path left the window
        if k + 1 < len(segs):   # where the next segment's walk begins
            assert (p, t) == segs[k + 1]
    return tok


def segment_parse(x: torch.Tensor, xl: torch.Tensor, seg: int):
    """The three segment kernels on every row -> (tokens, ntok), as
    deflate_parse_greedy returns them."""
    b, n = x.shape
    tokens = torch.zeros((b, n), dtype=torch.int32)
    ntok = torch.zeros(b, dtype=torch.int32)
    rows = x.numpy()
    for r, ba in enumerate(_best_at(x, xl)):
        ln = min(max(int(xl[r]), 0), n)
        segs, total = _chain(_maps(ba, ln, seg), seg)
        tokens[r] = torch.tensor(_emit(rows[r], ba, ln, seg, segs, n),
                                 dtype=torch.int32)
        ntok[r] = total
    return tokens, ntok


@pytest.mark.parametrize("seg", [258, 300, 512, dc.PARSE_SEG])
def test_segment_parse_equals_greedy_plain(seg):
    """The replica's tokens and counts are the plain greedy parse's on
    every row, and the edge row's matches do end at the segments' edges;
    on the zero and period rows a walk from a segment's start misses the
    true path (so the entry maps are what make them right)."""
    rows, lens, ends = chip_smoke.segment_rows(seg, seg)
    x, xl = torch.from_numpy(rows), torch.from_numpy(lens)
    want = dc.deflate_parse_plain(x, xl, dc.deflate_links_plain(x, xl), 1,
                                  greedy=True)
    got = segment_parse(x, xl, seg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for r, at in ends.items():
        assert at <= chip_smoke.match_ends(
            want[0][r, : int(want[1][r])].tolist()), r
    starts = set()   # the true path's positions on the zero row
    p, ba = 0, _best_at(x[:1], xl[:1])[0]
    while p < int(xl[0]):
        starts.add(p)
        p += ba[p] >> 16 if ba[p] >> 16 >= dc.MIN_MATCH else 1
    assert any(k * seg not in starts for k in range(1, 4))


def test_segment_parse_on_the_lz77_stage_rows():
    """The replica on the rows that test_greedy_parse_equals_lz77_stage
    holds the plain greedy parse to tpuzip's lz77_stage on."""
    x, lens = (torch.from_numpy(a) for a in xla_rows())
    want = dc.deflate_parse_plain(x, lens, dc.deflate_links_plain(x, lens),
                                  1, greedy=True)
    got = segment_parse(x, lens, 512)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _hash(row: np.ndarray, p: int) -> int:
    word = int.from_bytes(row[p : p + 3].tobytes(), "little")
    return (word * HASH_MUL % (1 << 32)) >> (32 - HASH_BITS)


def tiled_links(row: np.ndarray, ln: int, tile: int) -> list:
    """lz4_shared.cuh's links_tiled_kernel and links_carry_kernel under
    deflate's key (csrc/deflate_encode.cu's tiled links) on one row:
    each tile's positions below the limit linked by the split_row replica
    as a row of their own (-1 where the tile holds no earlier position of
    the hash), its table and, for each hash it holds, its first position;
    then each hash's tiles in order, the first position of each taking
    the last position of the hash in the tiles before."""
    n = len(row)
    limit = max(ln - 2, 0)
    prev = [-1] * n
    tables = []
    for t0 in range(0, limit, tile):
        live = min(limit - t0, tile, n - t0)
        got, _, table = _split_row(row[t0 : t0 + live + 2], live + 2)
        first = {}
        for p in range(live):
            prev[t0 + p] = -1 if got[p] < 0 else t0 + got[p]
            if got[p] < 0:
                first[_hash(row, t0 + p)] = p
        assert {h for h, v in enumerate(table) if v} == set(first)
        tables.append((t0, table, first))
    for h in sorted(set().union(*(f for _, _, f in tables))):
        carried = -1
        for t0, table, first in tables:
            if table[h]:
                if carried >= 0:
                    prev[t0 + first[h]] = carried
                carried = t0 + table[h] - 1
    return prev


@pytest.mark.parametrize("tile", [300, 1000, 2048])
def test_tiled_links_equal_plain(tile):
    """The tiled replica's prev is the plain links' on every row: at any
    distance, across one or two tiles and past a tile with none of the
    hash."""
    rows, lens = chip_smoke.tile_rows(tile, tile)
    want = dc.deflate_links_plain(torch.from_numpy(rows),
                                  torch.from_numpy(lens))
    for r in range(len(rows)):
        assert tiled_links(rows[r], int(lens[r]), tile) == \
            want[r].tolist(), r
    far = [p - q for p, q in enumerate(want[2].tolist()) if q >= 0]
    assert max(far) > tile   # the third tile links past the zero tile


def test_tiled_links_at_the_kernel_width():
    """The replica at the kernel's LINK_TILE: text over two tiles and a
    bit of a third, and a zero row whose runs cross the tiles' edges."""
    n = 2 * dc.LINK_TILE + 1000
    rows = np.stack([np.frombuffer(chip_smoke.text_corpus(n, 7), np.uint8),
                     np.zeros(n, np.uint8)])
    lens = [n, n - 500]
    rows[1, lens[1]:] = 0
    want = dc.deflate_links_plain(torch.from_numpy(rows),
                                  torch.tensor(lens, dtype=torch.int32))
    for r in range(2):
        assert tiled_links(rows[r], lens[r], dc.LINK_TILE) == \
            want[r].tolist(), r


def test_tile_fits_the_slots():
    """A tile's positions, + 1, fit the u16 slots of split_row's table, and
    a row of the wide path is tiles of the kernel's width."""
    assert dc.LINK_TILE <= 0xFFFF   # p + 1 for p < LINK_TILE
    assert dc.links_route(dc.STAGE_MAX + 1) == "tiled"
    assert dc.LINK_TILE == 1 << 15
