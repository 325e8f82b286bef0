"""The warp form of csrc/deflate_encode.cu's tables kernel, replicated in
Python: libstdc++'s std::sort run by a whole warp (every range past 16
items partitioned by pairing the k-th element from the left that is not
below the pivot with the k-th from the right that is not above it; the
final insertion sort as a stable sort of each final range, each item
placed by counting), and package-merge on it with each level's marking
done over its taken items at once.  The permutation of ids, not only the
weights, must equal kernels/deflate_coder.std_sort's (hazard (x)), and
the code lengths deflate_coder.package_merge's."""

import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_deflate_tables import _median_of_three_killer, _tie_rows
from tpuzip_torch.kernels import deflate_coder as dc

@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair_partition(a: list, first: int, last: int) -> int:
    """__unguarded_partition_pivot by pairing: the median of three moved to
    first (one lane), then both lists by ballots and prefix counts, the
    pairs swapped while they have not crossed (one lane a pair), and the
    cut where the left scan would stop."""
    mid = first + (last - first) // 2
    dc._move_median_to_first(a, first, first + 1, mid, last - 1)
    p = a[first][0]
    left = [i for i in range(first + 1, last) if a[i][0] >= p]
    right = [i for i in range(last - 1, first, -1) if a[i][0] <= p]
    k = 0
    while k < min(len(left), len(right)) and left[k] < right[k]:
        k += 1
    for i, j in zip(left[:k], right[:k]):   # disjoint pairs
        a[i], a[j] = a[j], a[i]
    if k == 0:
        return left[0]
    return min(left[k], right[k - 1]) if k < len(left) else right[k - 1]


def warp_sort(a: list) -> int:
    """std::sort of (weight, id) pairs by weight, in place, as the warp
    runs it; returns how often a heap-sort fallback ran."""
    n = len(a)
    if n < 2:
        return 0
    block = [(p, p + 1) for p in range(n)]   # each position's final range
    fallbacks = 0
    stack = [(0, n, 2 * (n.bit_length() - 1))]
    while stack:                      # the whole warp
        first, last, depth = stack.pop()
        while last - first > dc.THRESHOLD:
            if depth == 0:            # lane 0
                dc._heap_sort(a, first, last)
                fallbacks += 1
                first = last
                break
            depth -= 1
            c = _pair_partition(a, first, last)
            stack.append((c, last, depth))
            last = c
        for p in range(first, last):
            block[p] = (first, last)
    # the final pass, a lane an item: the items of its range below it and
    # the equal ones before it
    out = list(a)
    for p, (f, l) in enumerate(block):
        w = a[p][0]
        out[f + sum(1 for q in range(f, l)
                    if a[q][0] < w or (a[q][0] == w and q < p))] = a[p]
    a[:] = out
    return fallbacks


def package_merge_warp(freq: list, maxbits: int):
    """package_merge on warp_sort: a level whose packages equal the previous
    level's (so its items do too) keeps the previous level's order, and
    the marking takes each level's taken items at once.  Returns (lengths,
    the levels whose sort was skipped)."""
    lens = [0] * len(freq)
    leaves = [(f, s) for s, f in enumerate(freq) if f > 0]
    if len(leaves) < 2:
        if leaves:
            lens[leaves[0][1]] = 1
        return lens, 0
    cur, packages, skipped, levels = [], None, 0, []
    for _ in range(maxbits):
        pk = [cur[i][0] + cur[i + 1][0] for i in range(0, len(cur) - 1, 2)]
        if pk == packages:
            skipped += 1              # the same items: the same order
        else:
            cur = leaves + [(w, dc.PKG + k) for k, w in enumerate(pk)]
            warp_sort(cur)
        packages = pk
        levels.append([node for _, node in cur])
    lens = np.zeros(len(freq), np.int64)
    taken = np.arange(len(cur)) < 2 * len(leaves) - 2
    for at in range(maxbits - 1, -1, -1):   # a level's taken items at once
        hit = np.array(levels[at])[taken]
        np.add.at(lens, hit[hit < dc.PKG], 1)
        pk = hit[hit >= dc.PKG] - dc.PKG
        taken = np.zeros(len(levels[at - 1]) if at else 0, bool)
        taken[2 * pk] = taken[2 * pk + 1] = True
    lens = lens.tolist()
    return lens, skipped


def _ids(a: list) -> list:
    return [i for _, i in a]


def _check(weights) -> int:
    a = [(int(w), i) for i, w in enumerate(weights)]
    b = list(a)
    want = dc.std_sort(a)
    got = warp_sort(b)
    assert _ids(b) == _ids(a)
    assert got == want
    return got


@pytest.mark.parametrize("wmax", [1, 2, 3, 4])
def test_random_small_weights_permutation(wmax):
    """Sizes 0-40, 100, 300, 571 and 576 at weights below wmax: every id in
    the place std_sort puts it."""
    rng = np.random.default_rng(wmax)
    for n in list(range(41)) + [100, 300, 571, 576]:
        for _ in range(3):
            _check(rng.integers(0, wmax, n))


def test_shaped_inputs_permutation():
    """All equal, sorted, reversed and organ-pipe inputs, at the threshold's
    edge and at the trees' widths."""
    for n in (17, 31, 32, 33, 64, 65, 100, 286, 571, 576):
        half = np.arange(n // 2)
        shapes = [np.zeros(n), np.arange(n), np.arange(n)[::-1],
                  np.r_[half, half[::-1], [0] * (n % 2)],
                  np.arange(n) % 7, (np.arange(n) // 3)[::-1]]
        for w in shapes:
            _check(w)


@pytest.mark.parametrize("n", [40, 64, 300, 512, 576])
def test_killer_reaches_heap_fallback(n):
    """McIlroy's adversary drives both forms to the depth limit: the warp
    form's fallbacks, and its permutation, are std_sort's."""
    assert _check(_median_of_three_killer(n)) > 0


def _histograms(tokens: list):
    """The literal/length (EOB counted once) and distance histograms of a
    token row."""
    lfreq, dfreq = [0] * 286, [0] * 30
    for t in tokens:
        if t < 256:
            lfreq[t] += 1
        else:
            lfreq[257 + dc.len_code(t >> dc.MATCH_SHIFT)] += 1
            dfreq[dc.dist_code(t & 0xFFFF)] += 1
    lfreq[256] = 1
    return lfreq, dfreq


def _tie_histograms():
    """The literal/length, distance and code-length histograms of
    test_torch_deflate_tables' tie-heavy rows (dc.block_tables' counts)."""
    out = []
    for row in _tie_rows(11, 60):
        x = np.frombuffer(row, np.uint8)
        lz = dc.deflate_parse_plain(*_as_tensors(x), 128)
        tokens = lz[0][0, : int(lz[1][0])].tolist()
        lfreq, dfreq = _histograms(tokens)
        out.append((lfreq, 15))
        out.append((dfreq, 15))
        llen, dlen, head = dc.block_tables(tokens, 0)
        clfreq = [0] * 19
        hlit = 257 + (head[2][0])
        hdist = 1 + head[3][0]
        for sym, _, _ in dc._rle_lengths(llen[:hlit] + dlen[:hdist]):
            clfreq[sym] += 1
        out.append((clfreq, 7))
    return out


def _as_tensors(x: np.ndarray):
    blocks = torch.from_numpy(x.copy())[None]
    lens = torch.tensor([len(x)], dtype=torch.int32)
    return blocks, lens, dc.deflate_links_plain(blocks, lens)


def test_package_merge_levels_and_lengths():
    """Every level of package-merge on the tie-heavy rows' histograms: each
    level's items sorted by the warp form in std_sort's order, and the
    warp form's package-merge (a level of the previous level's packages
    skipped, the marking a level at once) gives package_merge's lengths;
    the skip fires on some of them."""
    skipped = 0
    for freq, maxbits in _tie_histograms():
        leaves = [(f, s) for s, f in enumerate(freq) if f > 0]
        cur = []
        for _ in range(maxbits if len(leaves) > 1 else 0):
            items = leaves + [(cur[i][0] + cur[i + 1][0], dc.PKG + i // 2)
                              for i in range(0, len(cur) - 1, 2)]
            ref = list(items)
            dc.std_sort(ref)
            warp_sort(items)
            assert _ids(items) == _ids(ref)
            cur = items
        lens, skip = package_merge_warp(freq, maxbits)
        assert lens == dc.package_merge(freq, maxbits)
        skipped += skip
    assert skipped


TABLE_ROWS = {name: spec for rows in chip_smoke.table_specs().values()
              for name, spec in rows.items()}


@pytest.mark.parametrize("name", list(TABLE_ROWS))
def test_table_rows_trees_and_streams(name):
    """chip_smoke's token rows built to stress the tables: valid streams
    (the plain emit's) that zlib inflates to the rows' bytes, the
    Fibonacci rows' literal/length codes at the 15-bit limit, and both
    trees of the warp form's package-merge equal to package_merge's."""
    tokens, raw = chip_smoke.table_row(*TABLE_ROWS[name], 7)
    assert zlib.decompress(dc._emit_row(raw, tokens, 0), -15) == raw
    for freq in _histograms(tokens):
        assert package_merge_warp(freq, 15)[0] == dc.package_merge(freq, 15)
    if "fibonacci" in name:
        assert max(dc.block_tables(tokens, 0)[0]) == 15
