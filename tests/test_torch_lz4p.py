"""The lz4p codec (id 7, columnar LZ sequences): tpuzip_torch against
tpuzip.  tpuzip writes lz4p with its C++ coder in compress (runs over 65535
bytes split) and with its XLA encoder in compress_from_device and
compress(device_encode=True) (unsplit columns); it decodes with the C++
coder to the host and with XLA into device memory.  On the CPU the port
runs the plain versions of kernels/lz4p_coder.py; the CUDA kernels of
csrc/lz4p.cu are held against them on the card by chip_smoke.py."""

import dataclasses
import struct

import jax
import numpy as np
import pytest
import torch

from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.runtime import native
from tpuzip.runtime.errors import TpzError
import tpuzip_torch
from tpuzip_torch.core import blocks as blk
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.kernels import lz4p_coder

MESH1 = meshlib.make_mesh(1)
with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()
N = 4096
RNG = np.random.default_rng(7)
DATA = (TEXT[:N] + bytes(700) + b"ab" * 900 + TEXT[N : N + 1500]
        + RNG.integers(0, 256, N, np.uint8).tobytes() + TEXT[:13])


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here: the plain versions run
    thousands of small tensor ops, and beside the other pytest-xdist
    workers each op's thread pool waits for cores they hold (with 8
    threads a worker under 6 workers, one case took 219 s against 0.8 s
    alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(hash_log=16, device_encode=False, inc=8, max_chain=1):
    cfg = Config()
    cfg.codec.lz4.hash_log = hash_log
    cfg.codec.lz4.device_encode = device_encode
    cfg.codec.lz4.max_chain = max_chain
    cfg.codec.ari.increment = inc
    return cfg


def _mine(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _decoded_by_both(blob, data):
    """Each package's decode of blob, to the host and into device
    memory."""
    assert tpuzip_torch.decompress(blob, device="cpu") == data
    assert jrun.decompress(blob, mesh=MESH1) == data
    out, olens, orig = tpuzip_torch.decompress(blob, device="cpu",
                                               to_device=True)
    ref, rolens, rorig = jrun.decompress(blob, mesh=MESH1, to_device=True)
    assert orig == rorig == len(data)
    assert np.array_equal(olens, np.asarray(rolens))
    assert np.array_equal(out.numpy(), np.asarray(ref)[: out.shape[0]])


def _both(data, block_size=N, cfg=None, checksums=False):
    cfg = cfg or Config()
    mine = tpuzip_torch.compress(data, codec="lz4p", block_size=block_size,
                                 device="cpu", config=_mine(cfg),
                                 block_checksums=checksums)
    ref = jrun.compress(data, codec="lz4p", block_size=block_size,
                        mesh=MESH1, config=cfg, block_checksums=checksums)
    assert mine == ref, (len(data), block_size)
    assert mine[4] == 7 and not mine[5] & 2
    return mine


@pytest.mark.parametrize("hash_log", [12, 16, 30])
def test_container_identical(hash_log):
    """compress: the C++ rule at the config's hash_log (30 taken as 16),
    max_chain ignored; each package decodes the other's."""
    assert native.available()
    blob = _both(DATA, cfg=_cfg(hash_log))
    _decoded_by_both(blob, DATA)
    assert blob == _both(DATA, cfg=_cfg(hash_log, max_chain=8))
    if hash_log == 30:
        assert blob == _both(DATA, cfg=_cfg(16))


def test_flags_and_small_corpora():
    """Flag 1 with block checksums, flag 4 with the ari knobs' trailer,
    never flag 2; empty and tiny corpora (an empty block is S = 1)."""
    blob = _both(DATA, 2048, checksums=True)
    assert blob[5] == 1
    _decoded_by_both(blob, DATA)
    assert _both(DATA, cfg=_cfg(inc=16))[5] == 4
    for data in (b"", b"x", bytes(13), b"hello world, hello world!"):
        _decoded_by_both(_both(data, 512), data)
    assert _both(b"", 512)[30:] == struct.pack("<II", 1, 0) + bytes(6)


def test_runs_past_u16_are_split():
    """The C++ rule splits a 64 KiB block without a match into 65,535 + 1
    literals, and a 256 KiB all-zero block's match into pieces of 65,535;
    both decode in both packages."""
    rand = RNG.integers(0, 256, 1 << 16, np.uint8).tobytes()
    blob = _both(rand, 1 << 16)
    assert struct.unpack_from("<IIHH", blob, 30) == (2, 1 << 16, 65535, 1)
    _decoded_by_both(blob, rand)
    zero = bytes(1 << 18)
    blob = _both(zero, 1 << 18)
    nseq, = struct.unpack_from("<I", blob, 30)
    mlens = struct.unpack_from(f"<{nseq}H", blob, 38 + 2 * nseq)
    assert mlens == (65535,) * 3 + ((1 << 18) - 6 - 3 * 65535, 0)
    assert tpuzip_torch.decompress(blob, device="cpu") == zero
    assert jrun.decompress(blob, mesh=MESH1) == zero


def test_device_encoder_containers_identical():
    """compress(device_encode=True) and compress_from_device: the XLA rule
    at hash_log 15, whatever the config's; each package decodes the
    other's."""
    cfg = _cfg(12, device_encode=True)
    mine = tpuzip_torch.compress(DATA, codec="lz4p", block_size=N,
                                 device="cpu", config=_mine(cfg))
    assert mine == jrun.compress(DATA, codec="lz4p", block_size=N,
                                 mesh=MESH1, config=cfg)
    _decoded_by_both(mine, DATA)
    blocks, lens = blk.chunk(DATA, N)
    blocks[-1, lens[-1]:] = RNG.integers(0, 256, N - lens[-1])
    mine = tpuzip_torch.compress_from_device(blocks, lens, "lz4p",
                                             block_checksums=True,
                                             device="cpu")
    ref = jrun.compress_from_device(jax.numpy.asarray(blocks), lens, "lz4p",
                                    block_checksums=True, mesh=MESH1)
    assert mine == ref
    _decoded_by_both(mine, DATA)


def test_xla_rule_refusals():
    """Fault 7: tpuzip's XLA encoder writes a 65,536-byte literal run as 0
    in its u16 column, and neither of its decoders reads the container
    back; the port refuses those rows (ValueError) and blocks past 65,536
    bytes (tpuzip asserts)."""
    rows = np.random.default_rng(2).integers(0, 256, (2, 1 << 16), np.uint8)
    for row in rows:   # no 4 bytes repeat: no match, one 65,536-byte run
        assert len({row[p : p + 4].tobytes() for p in range(65533)}) == 65533
    with pytest.raises(ValueError, match=r"blocks \[0, 1\]"):
        tpuzip_torch.compress_from_device(rows, [1 << 16] * 2, "lz4p",
                                          device="cpu")
    ref = jrun.compress_from_device(jax.numpy.asarray(rows), [1 << 16] * 2,
                                    "lz4p", mesh=MESH1)
    for to_device in (False, True):
        with pytest.raises(TpzError):
            jrun.decompress(ref, mesh=MESH1, to_device=to_device)
    with pytest.raises(ValueError, match="at most 65536"):
        tpuzip_torch.compress(bytes(1 << 17), codec="lz4p",
                              block_size=1 << 17, device="cpu",
                              config=_mine(_cfg(device_encode=True)))


def test_corpus_api():
    mine = tpuzip_torch.compress_corpus(DATA, codec="lz4p", block_size=2048,
                                        superbatch=4096, device="cpu")
    assert mine == jrun.compress_corpus(DATA, codec="lz4p", block_size=2048,
                                        superbatch=4096, mesh=MESH1)
    assert tpuzip_torch.decompress(mine, device="cpu") == DATA
    assert tpuzip_torch.decompress_corpus(mine, device="cpu") == DATA


def _corruptions(blob):
    """(name, container) pairs, each corrupt in a way that tpuzip's C++
    and XLA decoders both reject: block 0's payload starts at 26 + 4 nb.
    Not here: an orig_len past the block, which the C++ decoder and the
    port refuse, and the XLA one takes as the block size (hazard (v))."""
    nb, = struct.unpack_from("<I", blob, 10)
    p = 26 + 4 * nb
    nseq, = struct.unpack_from("<I", blob, p)
    out = []

    def put(name, at, fmt, value):
        b = bytearray(blob)
        struct.pack_into(fmt, b, at, value)
        out.append((name, bytes(b)))

    put("columns past the stream", p, "<I", 1 << 20)
    put("orig_len short of the sequences", p + 4, "<I", 100)
    put("offset 0", p + 8 + 4 * nseq, "<H", 0)
    put("offset past the output", p + 8 + 4 * nseq, "<H", 60000)
    put("literals past orig_len", p + 8, "<H", 5000)
    return out


def test_corrupt_containers_raise_as_tpuzip():
    """Each corruption raises the same error class in the port as in both
    of tpuzip's decoders, to the host and into device memory."""
    blob = _both(DATA)
    for name, bad in _corruptions(blob):
        classes = set()
        for to_device in (False, True):
            for decode in (lambda: tpuzip_torch.decompress(
                    bad, device="cpu", to_device=to_device),
                    lambda: jrun.decompress(bad, mesh=MESH1,
                                            to_device=to_device)):
                with pytest.raises(Exception) as err:
                    decode()
                classes.add(type(err.value).__name__)
        assert len(classes) == 1, (name, classes)


def test_plain_decoder_status_equals_native():
    """On valid, split, cut and garbage streams the plain decoder's status
    and output equal tpz_lz4p_decode's (through native)."""
    x = torch.from_numpy(np.frombuffer(DATA[: 2 * N], np.uint8).reshape(2, N)
                         .copy())
    lens = torch.full((2,), N, dtype=torch.int32)
    comp, clens = lz4p_coder.lz4p_encode_batch(x, lens)
    rows = [comp[r, : clens[r]].numpy().tobytes() for r in range(2)]
    rows += [rows[0][:cut] for cut in (0, 5, 8, 30, len(rows[0]) - 1)]
    rows += [rows[1] + b"trailing"]
    for k in range(40):
        g = bytearray(RNG.integers(0, 256, 60, np.uint8).tobytes())
        struct.pack_into("<II", g, 0, k % 6, int(RNG.integers(0, 80)))
        rows.append(bytes(g))
    width = max(map(len, rows))
    streams = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        streams[i, : len(r)] = np.frombuffer(r, np.uint8)
    slens = np.array([len(r) for r in rows], np.int32)
    out, st = lz4p_coder.lz4p_decode_batch(torch.from_numpy(streams),
                                           torch.from_numpy(slens), N)
    ref, rst = native.lz4p_decode_batch_native(streams, slens, N)
    assert st.tolist() == rst.tolist()
    assert (st > 0).sum() == 3 and (st < 0).sum() > 40
    ok = rst >= 0
    assert np.array_equal(out.numpy()[ok], ref[ok])
    assert not out.numpy()[~ok].any()


# csrc/lz4p.cu's pack: its staging and batch constants
TILE, WIN, END_MAX = 1024, 128, 254


def _batch_parse(stream: bytes, skew: int):
    """csrc/lz4p.cu's walk of one stream, replicated step for step: the
    ready bytes of a ring of TILE-byte tiles (the stream at `skew` past a
    16-byte boundary), the map of places to where a sequence starting
    there ends, its tables of 1, 2, 4, 8 and 16 jumps and the k-th start,
    and the sequences parsed alone -> [(literal source, literal length,
    match length, offset)] in order, and the sequences the batches took.
    Bytes the ring holds past the stream read as 0 here (the kernel reads
    whatever lies there; no such read decides a start)."""
    n = len(stream)

    def at(p):
        return stream[p] if p < n else 0

    lo = 0

    def need(p):
        nonlocal lo
        while p >= (lo + 2) * TILE - skew:
            lo += 1

    def hop(table, p):
        return table[p] if p < WIN else p

    out, batched, i = [], 0, 0
    while i < n:
        need(min(i + 2 * END_MAX, n - 1))
        lim = min(min(n, (lo + 2) * TILE - skew) - i, END_MAX)
        jump = []
        for q in range(WIN):
            t, b1 = at(i + q), at(i + q + 1)
            lext, mext = t >= 0xF0, t & 15 == 15
            lit = 15 + b1 if lext else t >> 4
            b2 = at(i + q + 1 + lext + lit + 2)
            end = q + 1 + lext + lit + 2 + mext
            long_ext = (lext and b1 == 255) or (mext and b2 == 255)
            jump.append(end if end <= lim and not long_ext else q)
        jumps = [jump]
        for _ in range(4):
            jumps.append([hop(jumps[-1], hop(jumps[-1], q))
                          for q in range(WIN)])
        starts = []
        for k in range(32):
            pos = 0
            for lvl in range(5):
                if (k >> lvl) & 1:
                    pos = hop(jumps[lvl], pos)
            starts.append(pos)
        # the tables give what stepping the map k times gives
        pos = 0
        for k in range(32):
            assert starts[k] == pos
            pos = hop(jump, pos)
        taken = [starts[k] < WIN and hop(jump, starts[k]) != starts[k]
                 for k in range(32)]
        count = sum(taken)
        assert all(taken[:count])
        p = starts[count] if count < 32 else hop(jump, starts[31])
        for q in starts[:count]:
            t, b1 = at(i + q), at(i + q + 1)
            lext = t >= 0xF0
            lit = 15 + b1 if lext else t >> 4
            frm = i + q + 1 + lext
            ml = (t & 15) + 4 + (at(frm + lit + 2) if t & 15 == 15 else 0)
            out.append((frm, lit, ml, at(frm + lit) | at(frm + lit + 1) << 8))
        batched += count
        i += p
        if not (count < 32 and p < WIN) or i >= n:
            continue
        token = at(i)
        i += 1
        run = token >> 4
        if run == 15:
            while True:
                b = at(i)
                i += 1
                run += b
                if not (b == 255 and i < n):
                    break
        src = i
        i = min(src + run, n)
        ml = off = 0
        if i < n:
            off = at(i) | at(i + 1) << 8
            i += 2
            ml = (token & 15) + 4
            if token & 15 == 15:
                while True:
                    b = at(i)
                    i += 1
                    ml += b
                    if not (b == 255 and i < n):
                        break
        out.append((src, run, ml, off))
        if ml == 0:
            break
    return out, batched


def _sequences(streams: list) -> list:
    """lz4p_coder._lz4_sequences of each stream, as _batch_parse's
    tuples."""
    w = max(map(len, streams))
    x = np.zeros((len(streams), w), np.uint8)
    for r, s in enumerate(streams):
        x[r, : len(s)] = np.frombuffer(s, np.uint8)
    cols = lz4p_coder._lz4_sequences(
        torch.from_numpy(x), torch.tensor([len(s) for s in streams],
                                          dtype=torch.int32))
    start, lit, ml, off, valid = (c.tolist() for c in cols)
    return [[(start[r][t], lit[r][t], ml[r][t], off[r][t])
             for t in range(len(valid[r])) if valid[r][t]]
            for r in range(len(streams))]


def _unrepeated(n: int) -> bytes:
    """n random bytes in which no 4 bytes repeat (no LZ4 match at all)."""
    for seed in range(100):
        row = np.random.default_rng(seed).integers(0, 256, n, np.uint8)
        words = np.lib.stride_tricks.sliding_window_view(row, 4).copy()
        if len(np.unique(words.view("<u4"))) == n - 3:
            return row.tobytes()
    raise AssertionError("no seed below 100 gives such a row")


def test_batch_parse_finds_the_sequences():
    """The pack kernel's batch parse finds the same sequences as the plain
    version's one-at-a-time parse, on streams of tpuzip's C++ encoder and
    of the port's plain one: text whose batches cross ring tiles, runs
    with extensions of 2 or more bytes, a 64 KiB block with no match
    (65,536 literals, split 65,535 + 1), zero rows, and at every skew of
    a row's start."""
    text = (TEXT * 3)[: 1 << 16]
    rand = _unrepeated(1 << 16)
    ext = bytes(600) + TEXT[:300] + b"xy" * 400 + bytes(3000) + TEXT[:40]
    streams = [native.lz4_compress(d) for d in
               (text, rand, bytes(1 << 16), ext, TEXT[:N], b"", b"abc")]
    x = torch.from_numpy(np.frombuffer(DATA[: 2 * N], np.uint8)
                         .reshape(2, N).copy())
    comp, clens = lz4p_coder.lz4_coder.lz4_encode_batch(
        x, torch.full((2,), N, dtype=torch.int32))
    streams += [comp[r, : clens[r]].numpy().tobytes() for r in range(2)]
    want = _sequences(streams)
    batched = 0
    for r, s in enumerate(streams):
        for skew in ((0, 5, 15) if r < 2 else (0,)):
            got, taken = _batch_parse(s, skew)
            assert got == want[r], (r, skew)
            batched += taken
    # the batches take most of the text's sequences, and the long
    # extensions (the random row's 257 bytes, the zero runs') are parsed
    # alone
    assert batched > 0.9 * len(want[0]) * 3
    assert max(t[1] for t in want[1]) == 1 << 16
    assert max(t[2] for t in want[3]) > 255 + 19
