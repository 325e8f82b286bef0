"""The deflate links' shared route on the CPU: a step-for-step replica of
csrc/lz4_shared.cuh's split_row under deflate's 3-byte key (csrc/
deflate_encode.cu's deflate_links_shared_kernel: 8 warps a row, one hash
class each, queues of 32, a scan of 128 positions inside a run of one hash
skipping the queue, a direct table of 2^15 u16 slots, the row's bytes read
as they lie) held against the
plain links, which tpuzip's C++ chain gives (tests/test_torch_deflate.py);
the route as a function of shape; and the CUDA wrappers refusing to fall
back to the plain version.  The kernel is held against the plain version
on the card by chip_smoke.py.  The tiled route (a tile run as a row of
this one, then a carry over the tiles) is replicated in
tests/test_torch_deflate_segments.py."""

import numpy as np
import pytest
import torch

from tpuzip.runtime import native
import chip_smoke
from tpuzip_torch.kernels import deflate_coder as dc

CLASSES, QUEUE, SCAN = 8, 32, 128
HASH_MUL, HASH_BITS = 2654435761, 15


def _split_row(row: np.ndarray, ln: int) -> tuple[list, dict, list]:
    """deflate_links_shared_kernel on one row of len(row) bytes, the first
    ln of them the block: each position's 3 bytes read from the row (none
    past it), each warp's queue filled 32 entries at a time from scans of
    128 positions and stepped through __match_any_sync's groups against
    the u16 table, runs emitted at once -> (prev, counts of the queue steps
    and run scans, the table after the row: slot h the last position of
    hash h, + 1, or 0)."""
    n = len(row)
    limit = max(ln - 2, 0)
    prev = [-1] * n
    table = [0] * (1 << HASH_BITS)
    queues = [[] for _ in range(CLASSES)]
    counts = {"steps": 0, "runs": 0}

    def key(p):
        assert p + 3 <= ln   # the 3 bytes lie in the block
        word = int.from_bytes(row[p : p + 3].tobytes(), "little")
        return (word * HASH_MUL % (1 << 32)) >> (32 - HASH_BITS)

    def step(entries):
        counts["steps"] += 1
        for lane, (p, h) in enumerate(entries):
            earlier = [q for q, g in entries[:lane] if g == h]
            prev[p] = earlier[-1] if earlier else table[h] - 1
        for lane, (p, h) in enumerate(entries):
            if all(g != h for _, g in entries[lane + 1 :]):
                assert p + 1 <= 0xFFFF   # a u16 slot
                table[h] = p + 1

    last = 0
    for first in range(0, limit, SCAN):
        ps = [p for p in range(first, first + SCAN)]
        hs = [key(p) if p < limit else 0 for p in ps]
        if first > 0 and first + SCAN <= limit and all(h == last
                                                       for h in hs):
            counts["runs"] += 1
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
    return prev, counts, table


def _rows():
    """Rows of the route: text, zeros, b"ab", chip_smoke's run rows (runs
    that start and end at every offset of a scan) and a random row, at
    2048 bytes, some of them shorter than their row; two rows of 65,536
    bytes (text, and zeros from byte 16 on: the slot takes p + 1 =
    65,534), and rows of 0-3 bytes."""
    n = 2048
    rng = np.random.default_rng(18)
    text = np.frombuffer(chip_smoke.text_corpus(n, 18), np.uint8)
    runs, _ = chip_smoke.run_rows(n, 19)
    small = np.stack([text, np.zeros(n, np.uint8), np.resize([97, 98], n),
                      *runs, rng.integers(0, 256, n)]).astype(np.uint8)
    lens = [n, n, n, n, n, 1500, n, 777]
    wide = np.zeros((2, 1 << 16), np.uint8)
    wide[0] = np.frombuffer(chip_smoke.text_corpus(1 << 16, 20), np.uint8)
    wide[1, :16] = rng.integers(1, 256, 16)
    tiny = np.frombuffer(b"abab", np.uint8)
    return [(small, lens), (wide, [1 << 16] * 2),
            (np.tile(tiny, (4, 1)), [0, 1, 2, 3])]


@pytest.mark.parametrize("group", range(3))
def test_split_row_replica_equals_plain(group):
    """The replica's prev is the plain links' on every row, and the route
    takes its run scans where a row runs (the zero rows and the run rows);
    the plain links are tpuzip's C++ chain (held in test_torch_deflate.py)."""
    rows, lens = _rows()[group]
    assert rows.dtype == np.uint8
    x = torch.from_numpy(np.ascontiguousarray(rows))
    xl = torch.tensor(lens, dtype=torch.int32)
    want = dc.deflate_links_plain(x, xl)
    for r in range(len(rows)):
        got, counts, _ = _split_row(rows[r], lens[r])
        assert got == want[r].tolist(), r
        if group == 0 and r in (1, 3):
            assert counts["runs"] > 0, r
    assert dc.links_route(rows.shape[1]) == "shared"


def test_plain_links_equal_native_chain():
    """The plain links reproduce the C++ encoder: tpuzip's tpz_deflate
    streams of the replica's wide rows equal the port's plain encode."""
    rows, lens = _rows()[1]
    x = torch.from_numpy(rows[:, :8192].copy())
    xl = torch.tensor([8192, 8192], dtype=torch.int32)
    assert native.available()
    comp, clens = dc.deflate_encode_batch(x, xl, 8, 0)
    ref, rlens = native.deflate_batch_native(rows[:, :8192].copy(),
                                             xl.numpy(), 8)
    assert clens.tolist() == list(rlens)
    for r in range(2):
        assert comp[r, : clens[r]].numpy().tobytes() == \
            ref[r, : rlens[r]].tobytes()


@pytest.mark.parametrize("n", [1, 2048, 65536, 65537, 1 << 17])
def test_links_route_is_a_function_of_shape(n):
    """The route: shared for rows of at most 65,536 bytes, tiled past
    them, whatever the batch or the bytes."""
    want = "shared" if n <= 65536 else "tiled"
    assert dc.links_route(n) == want
    assert dc.STAGE_MAX == 1 << 16


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

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.mark.parametrize("n", [2048, 1 << 17])
def test_cuda_links_raise_without_gpu(monkeypatch, n):
    """A CUDA tensor goes to the kernel on either route and raises without
    a GPU: the plain links never run for it."""
    def refuse(*args):
        raise AssertionError("the plain links ran for a CUDA tensor")

    monkeypatch.setattr(dc, "deflate_links_plain", refuse)
    x = _OnCuda(torch.zeros((2, n), dtype=torch.uint8))
    xl = _OnCuda(torch.full((2,), n, dtype=torch.int32))
    before = (dc.deflate_links_shared.launches,
              dc.deflate_links_tiled.launches)
    with pytest.raises((RuntimeError, AssertionError),
                       match="CUDA|cuda|GPU|driver"):
        dc.deflate_links(x, xl)
    assert (dc.deflate_links_shared.launches,
            dc.deflate_links_tiled.launches) == before
