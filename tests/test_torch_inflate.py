"""The deflate codec's inflate: kernels/deflate_coder.py's plain version
held against tpuzip's C++ ``tpz_inflate`` (its batch entry point, the one
``native.inflate_batch_native`` calls) status for status, and against
zlib on streams with many blocks.  The CUDA kernel of csrc/inflate.cu is
held against the plain version on the card by chip_smoke.py."""

import zlib

import numpy as np
import pytest
import torch

from tpuzip.runtime import native
from tpuzip_torch.kernels import deflate_coder as dc
from tpuzip_torch.oracle import deflate as odeflate

with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(streams):
    w = max(max(map(len, streams)), 1)
    x = np.zeros((len(streams), w), np.uint8)
    for i, s in enumerate(streams):
        x[i, : len(s)] = np.frombuffer(s, np.uint8)
    return x, np.array([len(s) for s in streams], np.int32)


def _native(x, lens, cap):
    """tpz_inflate_batch's outputs and statuses (-1 kept, not raised)."""
    lib = native.get_lib()
    out = np.zeros((x.shape[0], cap), np.uint8)
    status = np.zeros(x.shape[0], np.int64)
    lib.tpz_inflate_batch(native._u8(x), x.shape[0], x.shape[1],
                          native._i32(lens), native._u8(out), cap,
                          native._i64(status), 1)
    return out, status


def _held(streams, cap):
    """The plain inflate's statuses equal tpz_inflate's, and so do the
    bytes of every stream that decodes, up to its length (tpz_inflate's
    match copy may write past it; the port's rows are 0 there)."""
    assert native.available()
    x, lens = _rows(streams)
    out, status = dc.inflate_batch_plain(torch.from_numpy(x),
                                         torch.from_numpy(lens), cap)
    ref, rstatus = _native(x, lens, cap)
    assert status.tolist() == rstatus.tolist()
    for r, st in enumerate(rstatus):
        if st > 0:
            assert np.array_equal(out[r, :st].numpy(), ref[r, :st]), r
            assert not out[r, st:].any()
    return status


def _garbage(seed: int):
    """Random bytes under each block type, and valid streams with one bit
    flipped: the flips reach the dynamic header, the symbols and the
    distances."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(150):
        s = rng.integers(0, 256, int(rng.integers(1, 120)), np.uint8)
        s[0] = (int(s[0]) & 0xF9) | (2 * (k % 4))
        out.append(s.tobytes())
    good = [native.deflate(TEXT[:1500], 128, "dynamic"),
            native.deflate(TEXT[:900], 8, "fixed"),
            zlib.compress(TEXT[:2000], 9)[2:-4]]
    for k in range(150):
        s = bytearray(good[k % 3])
        s[int(rng.integers(0, len(s)))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(s))
    return out


@pytest.mark.parametrize("cap", [4096, 1200])
def test_garbage_status_equals_native(cap):
    """Statuses on 300 garbage streams, at out_cap above and below the
    decoded lengths.  None of them codes a match under an empty or
    oversubscribed distance table (hazard (y): tpz_inflate reads
    uninitialised memory there), nor puts a stored block after a Huffman
    one (fault 8)."""
    status = _held(_garbage(cap), cap)
    assert (status == -1).sum() > 100 and (status > 0).any()


def test_cut_streams_status_equals_native():
    """Every prefix of tpuzip's dynamic, fixed and stored streams and of a
    zlib stream: -1 until the stream is whole."""
    streams = []
    for mode in ("dynamic", "fixed", "stored"):
        full = native.deflate(TEXT[:700], 128, mode)
        streams += [full[:k] for k in range(len(full) + 1)]
    z = zlib.compress(TEXT[:1500], 6)[2:-4]
    streams += [z[:k] for k in range(len(z) + 1)]
    status = _held(streams, 4096)
    assert sorted(set(status.tolist())) == [-1, 0, 700, 1500]


def _multi_block(seed: int):
    """zlib streams of several blocks: sync and full flushes (empty stored
    blocks after Huffman blocks), stored blocks of level 0 and of
    incompressible data between Huffman blocks, every strategy."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(24):
        co = zlib.compressobj(int(rng.integers(0, 10)), zlib.DEFLATED, -15,
                              9, int(rng.integers(0, 5)))
        parts, s = [], b""
        for _ in range(int(rng.integers(1, 5))):
            n = int(rng.integers(1, 3000))
            part = (rng.integers(0, 256, n, np.uint8).tobytes() if k % 3 == 0
                    else TEXT[int(rng.integers(0, 20000)):][:n])
            parts.append(part)
            s += co.compress(part)
            s += co.flush(int(rng.choice([zlib.Z_SYNC_FLUSH,
                                          zlib.Z_FULL_FLUSH,
                                          zlib.Z_NO_FLUSH])))
        out.append((s + co.flush(), b"".join(parts)))
    return out


def test_multi_block_streams_decode():
    """Any RFC 1951 stream decodes, as zlib and the port's oracle copy
    decode it: stored, fixed and dynamic blocks in sequence."""
    cases = _multi_block(3)
    x, lens = _rows([s for s, _ in cases])
    out, status = dc.inflate_batch_plain(torch.from_numpy(x),
                                         torch.from_numpy(lens), 16384)
    for r, (s, raw) in enumerate(cases):
        assert zlib.decompress(s, -15) == raw
        assert odeflate.decompress(s) == raw
        assert status[r] == len(raw)
        assert out[r, : len(raw)].numpy().tobytes() == raw
        assert not out[r, len(raw):].any()


def test_stored_after_huffman_is_read_at_the_byte_boundary():
    """Fault 8 in tpuzip: tpz_inflate's lookahead buffers whole bytes that
    its stored-block alignment drops, so it refuses this valid stream (a
    Huffman block of Z_HUFFMAN_ONLY with a short end-of-block code, then
    the empty stored block of a sync flush); the port reads it as the RFC
    and zlib do."""
    co = zlib.compressobj(1, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    s = co.compress(b"ab" * 8) + co.flush(zlib.Z_SYNC_FLUSH)
    s += co.compress(b"ba") + co.flush()
    raw = b"ab" * 8 + b"ba"
    assert zlib.decompress(s, -15) == raw
    x, lens = _rows([s])
    _, rstatus = _native(x, lens, 4096)
    out, status = dc.inflate_batch_plain(torch.from_numpy(x),
                                         torch.from_numpy(lens), 4096)
    assert rstatus.tolist() == [-1]
    assert status.tolist() == [len(raw)]
    assert out[0, : len(raw)].numpy().tobytes() == raw


def test_empty_distance_table_fails_the_first_match():
    """Hazard (y): a dynamic block whose distance lengths are all 0 decodes
    its literals and fails at its first length symbol (-1); tpz_inflate
    reads its uninitialised root table there, so this case is held
    against the RFC, not against the C++."""
    lit = [0] * 286
    for s in (ord("a"), 256, 257):
        lit[s] = 2
    lit[ord("b")] = 2
    bits = []

    def put(v, n):
        bits.extend((v >> k) & 1 for k in range(n))

    put(1, 1)
    put(2, 2)
    put(286 - 257, 5)
    put(0, 5)          # one distance length, 0
    put(19 - 4, 4)
    cl = [0] * 19
    cl[0], cl[2] = 1, 1
    for s in odeflate.CLCL_ORDER:
        put(cl[s], 3)
    for ln in lit + [0]:   # code 0 is "0", code 1 is "2" (canonical)
        put(0 if ln == 0 else 1, 1)
    codes = dict(zip((ord("a"), ord("b"), 256, 257), (0, 1, 2, 3)))
    for sym in (ord("a"), ord("b"), 257):
        put(int(f"{codes[sym]:02b}"[::-1], 2), 2)
    put(0, 8)
    stream = bytes(int("".join(map(str, bits[k : k + 8][::-1])), 2)
                   for k in range(0, len(bits), 8))
    x, lens = _rows([stream])
    out, status = dc.inflate_batch_plain(torch.from_numpy(x),
                                         torch.from_numpy(lens), 64)
    assert status.tolist() == [-1]
    assert out[0, :3].numpy().tobytes() == b"ab\x00"
    with pytest.raises(zlib.error):
        zlib.decompress(stream, -15)


def test_wrapper_checks_and_empty_rows():
    """An empty row decodes to 0 bytes (an empty block); lengths past the
    row are read as the row; wrong types raise."""
    s = native.deflate(TEXT[:300], 128, "dynamic")
    x, lens = _rows([s, b""])
    lens[0] = 10_000
    out, status = dc.inflate_batch(torch.from_numpy(x),
                                   torch.from_numpy(lens), 512)
    assert status.tolist() == [300, 0]
    assert out[0, :300].numpy().tobytes() == TEXT[:300]
    with pytest.raises(TypeError):
        dc.inflate_batch(torch.from_numpy(x).to(torch.int32),
                         torch.from_numpy(lens), 512)
