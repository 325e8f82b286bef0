"""The lz4 codec (LZ4 blocks, tpuzip's default): tpuzip_torch against
tpuzip.

Off the TPU tpuzip encodes and decodes lz4 with its C++ coder, whose bytes
are tpuzip.oracle.lz4's greedy single-probe parse; on the CPU the port runs
the plain versions of its two kernels (kernels/lz4_coder.py), so the
containers here are the port's own code against tpuzip's C++.  The CUDA
kernels are held against the plain versions on the card by chip_smoke.py.
"""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from tpuzip.codecs import lz4 as jlz4
from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.oracle import lz4 as olz4
from tpuzip.runtime import native
import chip_smoke
import tpuzip_torch
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.kernels import lz4_coder

MESH1 = meshlib.make_mesh(1)
with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()[:3000]
DATA = TEXT + bytes(1500) + b"ab" * 600      # 5700 bytes


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


def _both(data, block_size=4096, cfg=None, checksums=False, codec="lz4"):
    """Both packages' containers (the port's from the same config carried
    across), held equal, each decoded by the other package."""
    mine = tpuzip_torch.compress(
        data, codec=codec, block_size=block_size, device="cpu",
        config=cfg and config_from_dict(dataclasses.asdict(cfg)),
        block_checksums=checksums)
    ref = jrun.compress(data, codec=codec, block_size=block_size, mesh=MESH1,
                        config=cfg, block_checksums=checksums)
    assert mine == ref, (codec, len(data), block_size, checksums)
    assert tpuzip_torch.decompress(ref, device="cpu") == data
    assert jrun.decompress(mine, mesh=MESH1) == data
    return mine


def test_default_call_is_tpuzips_default_container():
    """No codec and no block size: lz4 at 64 KiB blocks, as tpuzip.compress
    (held against the runner on a one-device mesh: tpuzip.compress pads
    the batch to the 8-device test mesh)."""
    assert native.available()
    mine = tpuzip_torch.compress(DATA, device="cpu")
    ref = jrun.compress(DATA, block_size=1 << 16, mesh=MESH1)
    assert mine == ref
    assert mine[4] == 1 and mine[5] == 0
    assert tpuzip_torch.decompress(ref, device="cpu") == DATA
    assert jrun.decompress(mine, mesh=MESH1) == DATA


def _lz4_config(hash_log):
    cfg = Config()
    cfg.codec.lz4.hash_log = hash_log
    return cfg


@pytest.mark.parametrize("hash_log", [12, 16, 20, 30])
def test_container_identical_hash_log(hash_log):
    """hash_log 30 is out of 4..24: the encoder takes 16, as the C++."""
    bs = 512 if hash_log == 16 else 4096
    blob = _both(DATA, bs, _lz4_config(hash_log))
    if hash_log == 30:
        assert blob == _both(DATA, bs)


def test_ari_knobs_ride_the_trailer():
    """ari knobs other than (8, 8192) set flag 4 and the <HI> trailer for
    every codec, as tpuzip's runner does, though lz4 does not use them."""
    cfg = Config()
    cfg.codec.ari.increment = 16
    blob = _both(DATA, 4096, cfg)
    assert blob[5] == 4
    assert len(blob) == len(_both(DATA, 4096)) + 6


def test_block_checksums_and_small_corpora():
    blob = _both(DATA, 2048, checksums=True)
    assert blob[5] == 1
    for data in (b"", b"x", b"hello world!", bytes(12)):
        _both(data, 512)
    empty = _both(b"", 512)
    nb, = struct.unpack_from("<I", empty, 10)
    assert nb == 1 and empty[26:30] == struct.pack("<I", 1)
    assert empty[30:] == b"\x00"


@pytest.mark.parametrize("option", ["device_encode", "max_chain"])
def test_port_decodes_tpuzips_other_encoders(option):
    """tpuzip's XLA encoder (device_encode=True) and its chained C++ one
    (max_chain=8) write other bytes, valid LZ4 all the same; the port
    decodes them and writes both (kernels/lz4_dense.py, kernels/
    lz4_chain.py; tests/test_torch_lz4_chain.py has the chained one's
    other cases)."""
    cfg = Config()
    if option == "device_encode":
        cfg.codec.lz4.device_encode = True
    else:
        cfg.codec.lz4.max_chain = 8
    ref = jrun.compress(DATA, block_size=4096, mesh=MESH1, config=cfg)
    assert ref != jrun.compress(DATA, block_size=4096, mesh=MESH1)
    assert tpuzip_torch.decompress(ref, device="cpu") == DATA
    mine = lambda: tpuzip_torch.compress(  # noqa: E731
        DATA, block_size=4096, device="cpu",
        config=config_from_dict(dataclasses.asdict(cfg)))
    assert mine() == ref


def _rows(blocks, n):
    out = np.zeros((len(blocks), n), np.uint8)
    for i, b in enumerate(blocks):
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return torch.from_numpy(out), torch.tensor([len(b) for b in blocks],
                                               dtype=torch.int32)


@pytest.mark.parametrize("hash_log", [12, 16, 20])
def test_plain_encoder_equals_oracle(rng, hash_log):
    """Every block's stream equals tpuzip.oracle.lz4.compress_block: text,
    runs over 255 bytes, period 2 and 3, random bytes, rows under 13
    bytes, empty; 0 past each stream."""
    blocks = [TEXT[:2048], TEXT[1000:1400] + bytes(700) + b"xy" * 300,
              b"abc" * 400, bytes(rng.integers(0, 256, 1500, np.uint8)),
              bytes(rng.integers(0, 3, 2048, np.uint8)), b"q" * 13,
              b"0123456789ab", b""]
    x, lens = _rows(blocks, 2048)
    comp, clens = lz4_coder.lz4_encode_batch(x, lens, hash_log)
    assert comp.shape == (len(blocks), lz4_coder.encode_cap(2048))
    for i, b in enumerate(blocks):
        exp = olz4.compress_block(b, hash_log)
        assert int(clens[i]) == len(exp)
        assert comp[i, : len(exp)].numpy().tobytes() == exp
        assert not comp[i, len(exp):].any()


@pytest.mark.parametrize("hash_log", [12, 16])
@pytest.mark.parametrize("window", [1, 7, 32, 64])
def test_plain_encoder_window_is_the_serial_parse(monkeypatch, rng, window,
                                                  hash_log):
    """The window construction that csrc/lz4_encode.cu runs at 32 positions
    a step (a position's candidate is the last earlier one of the window
    with its hash, else the table's slot read before the window's writes;
    the probed positions up to the first match write the table, the last
    of each hash) gives the serial parse's bytes at any window."""
    monkeypatch.setattr(lz4_coder, "WINDOW", window)
    blocks = [TEXT[:2048], TEXT[1000:1400] + bytes(700) + b"xy" * 300,
              b"abc" * 400, bytes(rng.integers(0, 3, 2048, np.uint8)),
              b"0123456789abc", b""]
    x, lens = _rows(blocks, 2048)
    comp, clens = lz4_coder.lz4_encode_batch(x, lens, hash_log)
    for i, b in enumerate(blocks):
        exp = olz4.compress_block(b, hash_log)
        assert comp[i, : int(clens[i])].numpy().tobytes() == exp


def test_far_repeats_container_identical():
    """Blocks of 128 KiB whose repeats lie 65,533 to 70,000 bytes back
    (chip_smoke.far_rows): the port's container is tpuzip's, each decodes
    the other's, and the offset bound binds: a repeat up to 65,535 back is
    taken, one further back is refused and its 3000 bytes stay literals."""
    rows, _ = chip_smoke.far_rows(7)
    blob = _both(rows.tobytes(), 1 << 17)
    nb, = struct.unpack_from("<I", blob, 10)
    clens = np.frombuffer(blob, "<u4", nb, 26)
    near = [g <= 0xFFFF for g in chip_smoke.FAR_GAPS]
    assert [int(c) < 5000 for c in clens[: len(near)]] == near


def _corrupt_streams():
    """(name, stream): valid streams, and the smoke's corrupt ones, one of
    each fault the status reports."""
    return [("text", olz4.compress_block(TEXT[:900])),
            ("zeros", olz4.compress_block(bytes(700))),
            ("period2", olz4.compress_block(b"ab" * 300)),
            ("empty", b""), ("literals only", b"\x30abc"),
            *chip_smoke.lz4_corrupt_streams(TEXT[:900])]


@pytest.mark.parametrize("out_cap", [1024, 640])
def test_plain_decoder_status_equals_native(out_cap):
    """Status (length or -1) and bytes equal tpuzip's C++ decoder's on
    valid rows and on each fault; out_cap 640 also puts literals and
    matches past the output's end."""
    cases = _corrupt_streams()
    w = max(len(s) for _, s in cases) + 8
    comp = np.zeros((len(cases), w), np.uint8)
    for i, (_, s) in enumerate(cases):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
    clens = np.array([len(s) for _, s in cases], np.int32)
    ref_out, ref_st = native.lz4_decompress_batch(comp, clens, out_cap)
    out, st = lz4_coder.lz4_decode_batch(torch.from_numpy(comp),
                                         torch.from_numpy(clens), out_cap)
    assert st.dtype == torch.int64
    np.testing.assert_array_equal(st.numpy(), ref_st)
    for i, (name, _) in enumerate(cases):
        n = max(int(ref_st[i]), 0)
        assert out[i, :n].numpy().tobytes() == ref_out[i, :n].tobytes(), name
        assert not out[i, n:].any(), name
    # the faults fail, the valid rows decode (text and zeros, 900 and 700
    # bytes, only into 1024)
    assert (ref_st[5:] == -1).all() and (ref_st[2:5] >= 0).all()
    assert ((ref_st[:2] >= 0) == (out_cap == 1024)).all()


def _outcome(decode, blob):
    try:
        return "ok", decode(blob)
    except Exception as e:   # noqa: BLE001 - the class is the outcome
        return type(e).__name__, str(e)


def _same_outcome(bad) -> str:
    """Both packages decode `bad` to the same bytes or raise the same class
    with the same message; returns the class name, or "ok"."""
    mine = _outcome(lambda b: tpuzip_torch.decompress(b, device="cpu"), bad)
    ref = _outcome(lambda b: jrun.decompress(b, mesh=MESH1), bad)
    assert mine == ref
    return mine[0]


def test_corrupt_containers_raise_the_same_error():
    """Both packages raise the same class with the same message (the
    blocks named): an offset of 0 in block 1, a decoded length short of
    the last block's, a payload past the codec's bound, and byte flips
    through the payload."""
    blob = _both(DATA, 2048)
    nb, = struct.unpack_from("<I", blob, 10)
    clens = np.frombuffer(blob, "<u4", nb, 26).astype(np.int64)
    base = 26 + 4 * nb
    starts = base + np.concatenate([[0], np.cumsum(clens)[:-1]])
    bad = bytearray(blob)
    at = int(starts[1]) + chip_smoke.first_offset(blob[starts[1]:])
    bad[at: at + 2] = b"\x00\x00"
    assert _same_outcome(bytes(bad)) == "CorruptStreamError"
    short = bytearray(blob)
    struct.pack_into("<Q", short, 14, len(DATA) - 1)
    assert _same_outcome(bytes(short)) == "ValueError"
    big = bytearray(blob)
    cap = jlz4.encode_cap(2048)
    big[26:30] = struct.pack("<I", cap + 1)
    big += bytes(cap + 1 - int(clens[0]))
    assert _same_outcome(bytes(big)) == "BlockLengthError"
    seen = {_same_outcome(bytes(blob[:k]) + bytes([blob[k] ^ 0x5A])
                          + blob[k + 1:])
            for k in range(base + 3, len(blob), 97)}
    assert {"CorruptStreamError", "ChecksumError"} <= seen


def test_plain_decoder_garbage_equals_native():
    """Status and bytes equal tpuzip's C++ decoder's on the smoke's 64
    garbage streams (random bytes; text streams with bytes changed, cut,
    or both) and on a text stream cut at every place: a stream may end
    right after a match as after a literal run, and decodes to its bytes
    so far."""
    good = olz4.compress_block(TEXT[:700])
    streams = chip_smoke.lz4_garbage(1000, 5) + [
        good[:k] for k in range(len(good) + 1)]
    w = max(map(len, streams)) + 8
    comp = np.zeros((len(streams), w), np.uint8)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
    clens = np.array([len(s) for s in streams], np.int32)
    ref_out, ref_st = native.lz4_decompress_batch(comp, clens, 1024)
    out, st = lz4_coder.lz4_decode_batch(torch.from_numpy(comp),
                                         torch.from_numpy(clens), 1024)
    np.testing.assert_array_equal(st.numpy(), ref_st)
    for i in range(len(streams)):
        n = max(int(ref_st[i]), 0)
        assert out[i, :n].numpy().tobytes() == ref_out[i, :n].tobytes()
        assert not out[i, n:].any()
    # some cuts end right after a match and decode
    ends = chip_smoke.lz4_offsets(good)
    assert len(ends) > 10 and (ref_st[64:] > 0).sum() > len(ends)


def _decode_in_rounds(stream: bytes, batch: int, out_cap: int):
    """csrc/lz4_decode.cu's rule on a valid stream: literals written as
    they are parsed, the matches of `batch` sequences at once in rounds.
    A match is ready when its source's end, start - off + min(off, ml),
    is at or before the earliest pending match's start; a round loads
    every ready match's bytes by the periodic rule out[o - off + m % off],
    then stores them.  Returns (the output, the rounds)."""
    out = np.zeros(out_cap, np.uint8)
    src = np.frombuffer(stream, np.uint8)
    pending, rounds = [], 0

    def length(nib, p):
        if nib == 15:
            while src[p] == 255:
                nib += 255
                p += 1
            nib += int(src[p])
            p += 1
        return nib, p

    def resolve():
        nonlocal pending, rounds
        while pending:
            first = min(mo for mo, _, _ in pending)
            ready = [(mo, off, ml) for mo, off, ml in pending
                     if mo - off + min(off, ml) <= first]
            assert ready, "the earliest pending match is always ready"
            loads = [out[mo - off + np.arange(ml) % off] for mo, off, ml
                     in ready]
            for (mo, _, ml), v in zip(ready, loads):
                out[mo : mo + ml] = v
            pending = [m for m in pending if m not in ready]
            rounds += 1

    i = o = 0
    while i < len(src):
        token = int(src[i])
        lit, i = length(token >> 4, i + 1)
        out[o : o + lit] = src[i : i + lit]
        i, o = i + lit, o + lit
        if i >= len(src):
            break
        off = int(src[i]) | int(src[i + 1]) << 8
        ml, i = length(token & 15, i + 2)
        pending.append((o, off, ml + 4))
        o += ml + 4
        if len(pending) == batch:
            resolve()
    resolve()
    return out[:o].tobytes(), rounds


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_round_resolution_decodes(rng, batch):
    """The rounds of csrc/lz4_decode.cu decode tpuzip.oracle.lz4 streams
    back to their input: text, random bytes of periods 1 to 31 (offsets
    under the match length) and the smoke's 128 KiB rows whose repeats lie
    65,533 to 70,000 bytes back.  A batch of 32 takes fewer rounds than
    one of 8, and a batch of 1 one round a match."""
    text = chip_smoke.text_corpus(1 << 14, 3)
    periods = [np.resize(rng.integers(0, 256, p), 3000).astype(
        np.uint8).tobytes() for p in range(1, 32)]
    far, _ = chip_smoke.far_rows(7)
    blocks = [text, TEXT, *periods, *(r.tobytes() for r in far[[1, 2, 7]])]
    rounds = 0
    for block in blocks:
        stream = olz4.compress_block(block)
        got, r = _decode_in_rounds(stream, batch, len(block))
        assert got == block
        rounds += r
    matches = sum(len(chip_smoke.lz4_offsets(olz4.compress_block(b)))
                  for b in blocks)
    if batch == 1:
        assert rounds == matches
    else:
        assert rounds < matches / (2 if batch == 8 else 4)
