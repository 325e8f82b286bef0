"""The deflate encoder's tables: kernels/deflate_coder.py's replica of
libstdc++'s std::sort and package-merge, held against tpuzip's C++ bytes
(``native.deflate``) on inputs with many equal weights, where the order of
ties decides the code lengths (hazard (x))."""

import heapq
import zlib

import numpy as np
import pytest
import torch

from tpuzip.oracle import deflate as jdeflate
from tpuzip.runtime import native
from tpuzip_torch.kernels import deflate_coder as dc


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _encode(rows, max_chain=128, mode=0):
    """The port's streams of a list of byte strings."""
    n = max(max(map(len, rows)), 1)
    x = np.zeros((len(rows), n), np.uint8)
    for i, r in enumerate(rows):
        x[i, : len(r)] = np.frombuffer(r, np.uint8)
    comp, clens = dc.deflate_encode_batch(
        torch.from_numpy(x), torch.tensor([len(r) for r in rows],
                                          dtype=torch.int32), max_chain, mode)
    return [comp[i, : clens[i]].numpy().tobytes() for i in range(len(rows))]


def _tie_rows(seed: int, count: int):
    """Short rows, rows over 2 to 6 symbols and rows of equal runs: their
    histograms, and so each package-merge level, hold many equal
    weights."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(count):
        n = int(rng.integers(1, 60 if k % 3 == 0 else 900))
        alpha = int(rng.integers(1, 7))
        syms = rng.permutation(256)[:alpha]
        if k % 3 == 2:   # runs of a few fixed lengths
            row = np.repeat(rng.choice(syms, n), rng.choice([1, 3, 4], n))
        else:
            row = rng.choice(syms, n)
        rows.append(row[:n].astype(np.uint8).tobytes())
    return rows


@pytest.mark.parametrize("max_chain", [1, 8, 128])
@pytest.mark.parametrize("mode", [0, 1])
def test_tie_heavy_rows_equal_native(mode, max_chain):
    """Row by row, the port's streams are tpz_deflate's on 90 rows whose
    weights tie: short rows, few symbols, equal runs."""
    assert native.available()
    rows = _tie_rows(7 + max_chain + mode, 90)
    got = _encode(rows, max_chain, mode)
    name = ("dynamic", "fixed")[mode]
    for r, row in enumerate(rows):
        assert got[r] == native.deflate(row, max_chain, name), r
        assert zlib.decompress(got[r], -15) == row


def test_code_length_tree_ties_equal_native():
    """The code-length code (19 symbols at 7 bits) ties too: rows whose
    literal lengths come in few distinct values, and rows with every byte
    value once or twice (286-symbol trees of equal weights)."""
    rng = np.random.default_rng(3)
    rows = [rng.permutation(256).astype(np.uint8).tobytes()
            * int(rng.integers(1, 3)) for _ in range(6)]
    rows += [bytes(range(k)) * 3 for k in (2, 17, 64, 129, 255)]
    rows += [bytes(rng.choice(256, 400, p=np.r_[np.full(16, 0.05),
                                                np.full(240, 0.2 / 240)])
                   .astype(np.uint8)) for _ in range(6)]
    for r, (got, row) in enumerate(zip(_encode(rows), rows)):
        assert got == native.deflate(row, 128, "dynamic"), r


def test_degenerate_tables_equal_native():
    """An empty block (EOB alone: two literal lengths), one literal, a run
    (one distance code), random bytes with no match (one distance length
    all the same), and one match (hazard (z))."""
    rows = [b"", b"a", b"zz", b"a" * 300, bytes(range(200)),
            b"abcabc", b"ab" * 3]
    for r, (got, row) in enumerate(zip(_encode(rows), rows)):
        assert got == native.deflate(row, 128, "dynamic"), r
    assert _encode([b""])[0] == native.deflate(b"", 128, "dynamic")


def _optimal_cost(freq: list, limit: int) -> int:
    """sum freq * length of an optimal length-limited code: tpuzip's
    oracle package-merge (stable sort, other ties, the same cost)."""
    lens = jdeflate.package_merge(
        {s: f for s, f in enumerate(freq) if f}, limit)
    return sum(freq[s] * ln for s, ln in lens.items())


@pytest.mark.parametrize("limit", [7, 15])
def test_package_merge_is_optimal_and_complete(limit):
    """Whatever the order of ties, package-merge gives an optimal code
    within the limit whose Kraft sum is 1; its tie order differs from a
    stable sort's on some of these histograms."""
    rng = np.random.default_rng(limit)
    differs = 0
    for k in range(60):
        n = 19 if limit == 7 else 286
        freq = [0] * n
        for s in rng.choice(n, int(rng.integers(2, n)), replace=False):
            freq[s] = int(rng.choice([1, 1, 2, 3, 5, 8]))
        lens = dc.package_merge(freq, limit)
        used = [ln for f, ln in zip(freq, lens) if f]
        assert all(0 < ln <= limit for ln in used)
        assert sum(2.0 ** -ln for ln in used) == 1.0
        assert sum(f * ln for f, ln in zip(freq, lens)) == \
            _optimal_cost(freq, limit)
        stable = jdeflate.package_merge(
            {s: f for s, f in enumerate(freq) if f}, limit)
        differs += any(stable[s] != lens[s] for s in stable)
    assert differs


def test_std_sort_orders_and_falls_back():
    """std_sort orders by weight alone on tie-heavy lists of every size
    around the threshold, and on a median-of-three killer its heap-sort
    fallback runs (the depth limit 2 floor(log2 n)) and still orders."""
    rng = np.random.default_rng(1)
    for n in list(range(0, 40)) + [100, 300, 571]:
        a = [(int(w), i) for i, w in enumerate(rng.integers(0, 4, n))]
        dc.std_sort(a)
        assert [w for w, _ in a] == sorted(w for w, _ in a)
        assert sorted(i for _, i in a) == list(range(n))
    n = 512
    killer = _median_of_three_killer(n)
    a = [(w, i) for i, w in enumerate(killer)]
    assert dc.std_sort(a) > 0
    assert [w for w, _ in a] == sorted(killer)


def _median_of_three_killer(n: int) -> list:
    """A permutation that drives libstdc++'s introsort to its depth limit:
    McIlroy's adversary ("A Killer Adversary for Quicksort"), weights fixed
    as the comparisons ask for them."""
    gas = n
    val = [gas] * n
    nsolid = [0]
    candidate = [0]

    class Key:
        def __init__(self, i):
            self.i = i

        def __lt__(self, other):
            a, b = self.i, other.i
            if val[a] == gas and val[b] == gas:
                if a == candidate[0]:
                    val[a] = nsolid[0]
                    nsolid[0] += 1
                else:
                    val[b] = nsolid[0]
                    nsolid[0] += 1
            if val[a] == gas:
                candidate[0] = a
            elif val[b] == gas:
                candidate[0] = b
            return val[a] < val[b]

    dc.std_sort([(Key(i), i) for i in range(n)])
    return val


def test_std_sort_matches_heapq_on_heap_fallback_ranges():
    """The heap-sort fallback orders on its own (a range sorted by the
    replica's make_heap/sort_heap equals heapq's order of weights)."""
    rng = np.random.default_rng(2)
    for n in (2, 3, 17, 64, 200):
        a = [(int(w), i) for i, w in enumerate(rng.integers(0, 9, n))]
        dc._heap_sort(a, 0, n)
        assert [w for w, _ in a] == [w for w, _ in
                                     heapq.nsmallest(n, a)]
