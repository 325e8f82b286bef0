"""lz4p's decode as csrc/lz4p.cu schedules it, on the CPU: a replica of the
kernel's two passes (the faults of every sequence by prefix sums, then
each batch of 32 sequences built in a history of the last HIST output
bytes: every literal byte first, a lane a byte, its sequence found by a
binary search over the scan of the literal lengths, while the short
matches whose sources lie before the batch load their bytes; then the
other matches in rounds, a match ready when its source ends at or before
the earliest pending match's start; a batch of more than HIST bytes built
in the output itself), held against the plain decoder and tpuzip's C++
tpz_lz4p_decode on both encoder rules' streams, on streams whose matches
reach 65,535 back, overlap themselves, read the matches of their own
batch or are one literal run, and on garbage.  Each byte a match reads
must be final when the round reads it, and every batch must end within
32 rounds.  The kernel is held against the plain decoder on the card by
chip_smoke.py."""

import struct

import numpy as np
import pytest
import torch

from tpuzip.runtime import native
import chip_smoke
from tpuzip_torch.kernels import lz4p_coder

HDR, BATCH, HIST, LANE_BYTES = 8, 32, 16384, 18
UNSET = -1   # an output byte no step has written


def rounds_decode(stream: bytes, out_cap: int):
    """csrc/lz4p.cu's decode of one stream -> (out (out_cap,) u8, status,
    [(rounds, direct, early matches) of each batch])."""
    n = len(stream)
    s = np.frombuffer(stream, np.uint8).astype(np.int64)
    S = orig = 0
    if n == 0:
        st = 0
    elif n < HDR:
        st = -1
    else:
        S, orig = struct.unpack_from("<II", stream)
        st = -1 if orig > out_cap or HDR + 6 * S > n else orig
    base = HDR + 6 * S
    if st > 0:   # pass 1
        col = [s[HDR + 2 * S * c : HDR + 2 * S * (c + 1)] for c in range(3)]
        ll, ml, off = (c[0::2] | c[1::2] << 8 for c in col)
        o = np.cumsum(ll + ml) - (ll + ml)
        lp = np.cumsum(ll) - ll
        ms = o + ll
        fault = ((base + lp + ll > n) | (ms > orig)
                 | ((ml > 0) & ((off == 0) | (off > ms)
                                | (ms + ml > orig))))
        if fault.any() or (ll + ml).sum() != orig:
            st = -1
    end = max(st, 0)
    dst = np.full(out_cap, UNSET, np.int64)
    hist = np.full(HIST, UNSET, np.int64)
    hist_lo, batches = 0, []
    for t0 in range(0, S if end else 0, BATCH):   # pass 2
        k = slice(t0, min(t0 + BATCH, S))
        bo, bll, bml, boff, blp = o[k], ll[k], ml[k], off[k], lp[k]
        o0, o1 = int(bo[0]), int(bo[-1] + bll[-1] + bml[-1])
        lp0, lits = int(blp[0]), int(bll.sum())
        direct = o1 - o0 > HIST
        lo = out_cap if direct else max(hist_lo, o1 - HIST)

        def put(p, v):
            if direct:
                dst[p] = v
            else:
                hist[p % HIST] = v

        def get(p):
            v = hist[p % HIST] if p >= lo else dst[p]
            assert v != UNSET, (t0, p)   # a round reads final bytes only
            return v

        # the first round's short matches whose sources lie before the
        # batch, loaded before the literals
        mo = bo + bll
        early = ((bml > 0) & (bml <= LANE_BYTES)
                 & (mo - boff + np.minimum(boff, bml) <= o0))
        loaded = {lane: [get(int(mo[lane] - boff[lane] + q % boff[lane]))
                         for q in range(int(bml[lane]))]
                  for lane in np.flatnonzero(early)}
        # the literals, a lane a byte
        lanes = np.arange(BATCH)
        lit_end = np.full(BATCH, lits)
        lit_end[: len(bll)] = np.cumsum(bll)
        shift = np.zeros(BATCH, np.int64)
        shift[: len(bll)] = bo - (blp - lp0)
        for b0 in range(0, lits, BATCH):
            b = b0 + lanes
            j = np.zeros(BATCH, np.int64)
            for step in (16, 8, 4, 2, 1):
                j += np.where(lit_end[j + step - 1] <= b, step, 0)
            for lane in np.flatnonzero(b < lits):
                put(int(shift[j[lane]] + b[lane]), s[base + lp0 + b[lane]])
        for lane, src in loaded.items():
            for q, v in enumerate(src):
                put(int(mo[lane]) + q, v)
        # the other matches, in rounds
        pending = (bml > 0) & ~early
        rounds = 0
        while pending.any():
            first = mo[pending].min()
            ready = pending & (mo - boff + np.minimum(boff, bml) <= first)
            for lane in np.flatnonzero(ready):
                m0, d = int(mo[lane]), int(boff[lane])
                src = [get(m0 - d + q % d) for q in range(int(bml[lane]))]
                for q, v in enumerate(src):
                    put(m0 + q, v)
            pending &= ~ready
            rounds += 1
        assert rounds <= BATCH
        batches.append((rounds, direct, int(early.sum())))
        if direct:
            hist_lo = o1
        else:
            dst[o0:o1] = hist[np.arange(o0, o1) % HIST]
    assert (dst[:end] != UNSET).all()
    dst[end:] = 0
    return dst.astype(np.uint8), st, batches


def _decode_all(streams: list, out_cap: int):
    """Every stream through the replica, the plain decoder and
    tpz_lz4p_decode (through tpuzip's native) -> the batches' rounds and
    direct flags; the three held equal (bytes up to a valid status)."""
    rows = np.zeros((len(streams), max(1, max(map(len, streams)))),
                    np.uint8)
    for r, stream in enumerate(streams):
        rows[r, : len(stream)] = np.frombuffer(stream, np.uint8)
    lens = np.array([len(st) for st in streams], np.int32)
    out, st = lz4p_coder.lz4p_decode_batch_plain(torch.from_numpy(rows),
                                                 torch.from_numpy(lens),
                                                 out_cap)
    ref, rst = native.lz4p_decode_batch_native(rows, lens, out_cap)
    assert st.tolist() == rst.tolist()
    batches = []
    for r, stream in enumerate(streams):
        got, gst, b = rounds_decode(stream, out_cap)
        assert gst == int(st[r]), r
        assert np.array_equal(got, out[r].numpy()), r
        if gst > 0:
            assert np.array_equal(got[:gst], ref[r, :gst]), r
        batches += b
    return batches


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (the plain versions' many small ops wait on the
    other pytest-xdist workers' cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("xla", [False, True])
def test_rounds_decode_encoder_rules(xla):
    """Both encoder rules' streams of text, zero, b"ab" and run rows of
    4 KiB decode by the schedule, in the history, within 32 rounds a
    batch."""
    n = 4096
    text = np.frombuffer(chip_smoke.text_corpus(2 * n, 18), np.uint8)
    runs, _ = chip_smoke.run_rows(n, 19)
    rows = np.stack([text[:n], text[n:], np.zeros(n, np.uint8),
                     np.resize([97, 98], n), runs[1]]).astype(np.uint8)
    x = torch.from_numpy(rows)
    xl = torch.tensor([n, n - 100, n, n, n], dtype=torch.int32)
    comp, clens = lz4p_coder.lz4p_encode_batch(x, xl, xla=xla)
    streams = [comp[r, : clens[r]].numpy().tobytes() for r in range(5)]
    batches = _decode_all(streams, n)
    assert len(batches) > 20 and not any(d for _, d, _ in batches)
    assert max(r for r, _, _ in batches) > 1
    assert sum(e for _, _, e in batches) > 0


def test_rounds_decode_edge_streams():
    """chip_smoke's lz4p edge streams (matches 65,535 back after a batch
    past the history, matches of offset 1-3 under long lengths, matches
    reading their own batch's matches, one literal run) decode by the
    schedule to their bytes: the far matches from device memory, the
    overlapping and chained ones in several rounds."""
    edges = chip_smoke.lz4p_edge_streams(chip_smoke.SEED + 22)
    for stream, raw in edges:
        got, st, _ = rounds_decode(stream, 1 << 17)
        assert st == len(raw) and got[:st].tobytes() == raw
    batches = _decode_all([st for st, _ in edges], 1 << 17)
    assert any(d for _, d, _ in batches) and \
        not all(d for _, d, _ in batches)
    assert max(r for r, _, _ in batches) >= 5


def test_rounds_decode_garbage():
    """chip_smoke's 64 garbage streams (made, bit-flipped, cut, trailing
    bytes) decode by the schedule to the plain decoder's bytes and
    statuses, tpz_lz4p_decode's."""
    _decode_all(chip_smoke.lz4p_garbage(chip_smoke.SEED + 14), 512)
