"""The rle codec: tpuzip_torch against tpuzip.

Off the TPU tpuzip encodes and decodes rle with its C++ loops, whose bytes
are tpuzip.oracle.rle's (a run's count bytes chain by 255 without bound);
on the CPU the port runs the plain versions of csrc/rle.cu's two kernels
(kernels/rle_coder.py), so the containers here are the port's own code
against tpuzip's C++.  The CUDA kernels are held against the plain
versions on the card by chip_smoke.py.
"""

import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuzip.codecs import rle as jrle
from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.oracle import rle as orle
from tpuzip.runtime import native
import chip_smoke
import tpuzip_torch
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.kernels import rle_coder

MESH1 = meshlib.make_mesh(1)
with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()[:3000]
# runs of 255, 256, 257 and 600 bytes (counts across the 255 chain), pairs
RUNS = b"x" * 255 + b"y" * 256 + b"z" * 257 + bytes(600) + b"aabbccdd" * 40
DATA = TEXT + RUNS + b"ab" * 300


def _both(data, block_size, cfg=None, checksums=False):
    mine = tpuzip_torch.compress(
        data, codec="rle", block_size=block_size, device="cpu",
        config=cfg and config_from_dict(dataclasses.asdict(cfg)),
        block_checksums=checksums)
    ref = jrun.compress(data, codec="rle", block_size=block_size, mesh=MESH1,
                        config=cfg, block_checksums=checksums)
    assert mine == ref, (len(data), block_size, checksums)
    assert tpuzip_torch.decompress(ref, device="cpu") == data
    assert jrun.decompress(mine, mesh=MESH1) == data
    return mine


@pytest.mark.parametrize("block_size", [512, 4096])
def test_container_identical(block_size):
    assert native.available()
    blob = _both(DATA, block_size)
    assert blob[4] == 2 and blob[5] == 0


def test_trailer_checksums_and_small_corpora():
    """ari knobs other than (8, 8192) set flag 4 and the trailer, as for
    every codec in tpuzip's runner; per-block Adler-32; a corpus under 13
    bytes and the empty one."""
    cfg = Config()
    cfg.codec.ari.increment = 16
    assert _both(DATA, 4096, cfg)[5] == 4
    assert _both(DATA, 1024, checksums=True)[5] == 1
    for data in (b"", b"z", b"zz", b"aab", bytes(12)):
        _both(data, 512)
    nb, = struct.unpack_from("<I", _both(b"", 512), 10)
    assert nb == 1


def _rows(blocks, n):
    out = np.zeros((len(blocks), n), np.uint8)
    for i, b in enumerate(blocks):
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out, np.array([len(b) for b in blocks], np.int32)


def test_plain_encoder_equals_oracle(rng):
    """Every block's stream equals tpuzip.oracle.rle.encode and the C++
    encoder's: text, runs over 255, alternating pairs (the 1.5x worst
    case), random bytes, a constant block, empty; 0 past each stream."""
    blocks = [TEXT[:2048], RUNS[:2048], b"aabb" * 512,
              bytes(rng.integers(0, 256, 1500, np.uint8)),
              bytes(rng.integers(0, 2, 2048, np.uint8)), b"q" * 2048, b"",
              b"p"]
    x, lens = _rows(blocks, 2048)
    comp, clens = rle_coder.rle_encode_batch(torch.from_numpy(x),
                                             torch.from_numpy(lens))
    ref, ref_lens = native.rle_encode_batch(x, lens)
    np.testing.assert_array_equal(clens.numpy(), ref_lens)
    for i, b in enumerate(blocks):
        exp = orle.encode(b)
        assert comp[i, : len(exp)].numpy().tobytes() == exp
        assert ref[i, : len(exp)].tobytes() == exp
        assert not comp[i, len(exp):].any()


def _by_place(block: bytes) -> bytes:
    """rle bytes from each input byte's place j in its run of R bytes (the
    rule csrc/rle.cu's encoder writes by): the byte when j is 0 or 1, a 255
    when j >= 2 and (j - 2) % 255 == 254, then, after a run's last byte
    with R >= 2, the remainder (j - 1) % 255."""
    x = np.frombuffer(block, np.uint8)
    if x.size == 0:
        return b""
    q = np.arange(x.size)
    head = np.concatenate([[True], x[1:] != x[:-1]])
    j = q - np.maximum.accumulate(np.where(head, q, 0))
    last = np.concatenate([x[1:] != x[:-1], [True]])
    val = (j <= 1) | ((j >= 2) & ((j - 2) % 255 == 254))
    cnt = last & (j >= 1)
    out = np.full((x.size, 2), -1, np.int64)
    out[val, 0] = np.where(j[val] <= 1, x[val], 255)
    out[cnt, 1] = (j[cnt] - 1) % 255
    out = out.reshape(-1)
    return out[out >= 0].astype(np.uint8).tobytes()


def test_byte_rule_equals_oracle(rng):
    """The rule on single runs of 1 to 1100 bytes (b b 0 at 2, b b 254 at
    256, b b 255 0 at 257) and on 2000 random blocks of runs of 1 to 1000
    bytes, against tpuzip.oracle.rle.encode."""
    assert _by_place(b"aa") == b"aa\x00"
    assert _by_place(b"a" * 256) == b"aa\xfe"
    assert _by_place(b"a" * 257) == b"aa\xff\x00"
    for r in range(1, 1101):
        assert _by_place(b"a" * r + b"b") == orle.encode(b"a" * r + b"b"), r
    for _ in range(2000):
        runs = rng.integers(1, 1001, rng.integers(1, 5))
        block = np.repeat(rng.integers(0, 3, runs.size), runs).astype(
            np.uint8).tobytes()
        assert _by_place(block) == orle.encode(block)


@pytest.mark.parametrize("block_size", [1 << 16, 4096])
def test_long_runs_container_identical(block_size):
    """A 64 KiB constant block, then runs of 255k + {0, 1, 2, 3} bytes for
    k up to 4, each of a byte other than its neighbours': the port's
    container is tpuzip's and each decodes the other's."""
    runs = [255 * k + d for k in range(5) for d in range(4) if k or d]
    data = b"c" * (1 << 16) + b"".join(
        bytes([i % 250 + 1]) * r for i, r in enumerate(runs * 2))
    blob = _both(data, block_size)
    assert blob[4] == 2


@pytest.mark.parametrize("out_cap", [1200, 300])
def test_plain_decoder_status_equals_native(out_cap):
    """Status (length or -1) and bytes equal tpuzip's C++ decoder's on valid
    streams, tpuzip's XLA encoder's 256-byte segments, a count past the
    stream (after a pair, and after 255), and output past out_cap (out_cap
    300 puts the long rows past it)."""
    seg_in = np.frombuffer(RUNS[:1100], np.uint8)
    seg, seg_len = jrle.encode(jnp.array(seg_in), jnp.int32(seg_in.size))
    segmented = np.asarray(seg)[: int(seg_len)].tobytes()
    streams = [orle.encode(TEXT[:1000]), orle.encode(RUNS[:1100]),
               segmented, b"", b"ab", b"aab", b"aa\x05b", b"xyzz\x00",
               *(st for _, st in chip_smoke.rle_corrupt_streams())]
    assert segmented != streams[1]
    x, clens = _rows(streams, max(len(s) for s in streams) + 4)
    ref_out, ref_st = native.rle_decode_batch(x, clens, out_cap)
    out, st = rle_coder.rle_decode_batch(torch.from_numpy(x),
                                         torch.from_numpy(clens), out_cap)
    assert st.dtype == torch.int64
    np.testing.assert_array_equal(st.numpy(), ref_st)
    for i in range(len(streams)):
        n = max(int(ref_st[i]), 0)
        assert out[i, :n].numpy().tobytes() == ref_out[i, :n].tobytes()
        assert not out[i, n:].any()
    assert (ref_st[-3:] == -1).all() and (ref_st[3:8] >= 0).all()
    assert ((ref_st[:3] >= 0) == (out_cap == 1200)).all()
    if out_cap == 1200:
        assert ref_st[1] == ref_st[2] == 1100


def _outcome(decode, blob):
    try:
        return "ok", decode(blob)
    except Exception as e:   # noqa: BLE001 - the class is the outcome
        return type(e).__name__, str(e)


def _same_outcome(bad) -> str:
    mine = _outcome(lambda b: tpuzip_torch.decompress(b, device="cpu"), bad)
    ref = _outcome(lambda b: jrun.decompress(b, mesh=MESH1), bad)
    assert mine == ref
    return mine[0]


def test_corrupt_containers_raise_the_same_error():
    """Both packages raise the same class with the same message (the blocks
    named): a pair with no count at block 1's end, a decoded length short
    of the last block's, a payload past the codec's bound, and byte
    flips."""
    blob = _both(DATA, 1024)
    nb, = struct.unpack_from("<I", blob, 10)
    clens = np.frombuffer(blob, "<u4", nb, 26).astype(np.int64)
    base = 26 + 4 * nb
    # block 1 (text) ends in a pair with no count after it
    cut = bytearray(blob)
    end1 = base + int(clens[0] + clens[1])
    cut[end1 - 2: end1] = b"\x01\x01"
    assert _same_outcome(bytes(cut)) == "CorruptStreamError"
    short = bytearray(blob)
    struct.pack_into("<Q", short, 14, len(DATA) - 1)
    assert _same_outcome(bytes(short)) == "ValueError"
    big = bytearray(blob)
    cap = jrle.encode_cap(1024)
    big[26:30] = struct.pack("<I", cap + 1)
    big += bytes(cap + 1 - int(clens[0]))
    assert _same_outcome(bytes(big)) == "BlockLengthError"
    seen = {_same_outcome(bytes(blob[:k]) + bytes([blob[k] ^ 0x5A])
                          + blob[k + 1:])
            for k in range(base + 3, len(blob), 61)}
    assert {"CorruptStreamError", "ChecksumError"} <= seen


@pytest.mark.parametrize("out_cap", [1200, 300])
def test_three_state_rule_equals_native(rng, out_cap):
    """The rule csrc/rle.cu's decoder runs by block scans
    (chip_smoke.rle_decode_model: S0 a literal disarmed, S1 a literal
    armed, S2 a count byte; the status -1 when the last byte leaves S2 or
    the output passes out_cap) gives tpuzip's C++ decoder's bytes and
    status on random streams, streams of {0, 1, 255}, valid streams cut at
    every place, tpuzip's XLA segment form (chip_smoke.rle_segments, held
    against tpuzip.codecs.rle.encode) and the smoke's garbage rows; the
    plain decoder does too on the garbage rows."""
    valid = orle.encode(RUNS[:1100])
    seg_in = np.frombuffer(RUNS[:1100] + TEXT[:200], np.uint8)
    seg, seg_len = jrle.encode(jnp.array(seg_in), jnp.int32(seg_in.size))
    segmented = np.asarray(seg)[: int(seg_len)].tobytes()
    assert chip_smoke.rle_segments(seg_in.tobytes()) == segmented
    garbage = chip_smoke.rle_garbage(3)
    streams = ([bytes(rng.integers(0, 256, rng.integers(1, 600), np.uint8))
                for _ in range(200)]
               + [rng.choice(np.array([0, 1, 255], np.uint8),
                             rng.integers(1, 40)).tobytes()
                  for _ in range(300)]
               + [valid[:k] for k in range(len(valid) + 1)]
               + [segmented] + garbage)
    x, clens = _rows(streams, max(map(len, streams)))
    ref_out, ref_st = native.rle_decode_batch(x, clens, out_cap)
    for i, st in enumerate(streams):
        got, status, _ = chip_smoke.rle_decode_model(st, out_cap)
        assert status == ref_st[i], i
        assert got == ref_out[i, : max(status, 0)].tobytes(), i
    assert (ref_st >= 0).sum() > 100 and (ref_st < 0).sum() > 100
    g = len(streams) - len(garbage)
    out, st = rle_coder.rle_decode_batch(torch.from_numpy(x[g:]),
                                         torch.from_numpy(clens[g:]),
                                         out_cap)
    np.testing.assert_array_equal(st.numpy(), ref_st[g:])
    for i in range(len(garbage)):
        n = max(int(ref_st[g + i]), 0)
        assert out[i, :n].numpy().tobytes() == ref_out[g + i, :n].tobytes()
        assert not out[i, n:].any()
