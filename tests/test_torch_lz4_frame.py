"""The LZ4 frame format: tpuzip_torch.codecs.lz4_frame against tpuzip's.

compress_frame writes tpuzip's bytes (its blocks from tpuzip's device lz4
encoder at hash_log 15, here the plain versions of kernels/lz4_dense.py;
xxh32 by kernels/xxh32.py's).  decompress_frame reads what tpuzip's
decompress_frame (its oracle's) reads, block checksums and linked blocks
included, and refuses what it refuses.  The history mode of the lz4
decoder (linked blocks) is held against the oracle's _decompress_linked.
"""

import functools
import struct

import numpy as np
import pytest
import torch

from tpuzip.codecs import lz4_frame as jframe
from tpuzip.oracle import lz4 as olz4
from tpuzip.oracle import xxh32 as oxxh32
import chip_smoke
from tpuzip_torch.codecs import lz4_frame as tframe
from tpuzip_torch.kernels import lz4_coder

with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    SURVEY = _f.read()
RNG = np.random.default_rng(2024)
TEXT = (SURVEY * 4)[:200_000]
INPUTS = {"empty": b"", "one": b"x", "text": TEXT, "zero": bytes(1 << 18),
          "random": RNG.integers(0, 256, 70_000, dtype=np.uint8).tobytes()}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the plain versions' small tensor ops wait on
    the other pytest-xdist workers' thread pools otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("block_max", [1 << 16, 1 << 18])
@pytest.mark.parametrize("name", list(INPUTS))
def test_compress_frame_is_tpuzips(name, block_max):
    data = INPUTS[name]
    if name == "zero" and block_max == 1 << 16:
        data = data[: 3 << 16]   # three blocks of zeros are enough there
    mine = tframe.compress_frame(data, block_max, device="cpu")
    assert mine == jframe.compress_frame(data, block_max)
    assert tframe.decompress_frame(mine, device="cpu") == data
    assert olz4.decompress_frame(mine) == data


def test_compress_frame_without_content_checksum():
    data = TEXT[:30_000]
    mine = tframe.compress_frame(data, content_checksum=False, device="cpu")
    assert mine == jframe.compress_frame(data, content_checksum=False)
    assert tframe.decompress_frame(mine, device="cpu") == data


@pytest.mark.parametrize("block_max", [1 << 16, 1 << 18])
def test_oracle_frames_with_block_checksums(block_max):
    """tpuzip's oracle writes block checksums (FLG bit 4) and stored blocks;
    the port reads them as tpuzip's decompress_frame does."""
    data = TEXT[:70_000] + RNG.integers(0, 256, 5_000,
                                        dtype=np.uint8).tobytes()
    frame = olz4.compress_frame(data, block_max=block_max,
                                block_checksum=True)
    assert tframe.decompress_frame(frame, device="cpu") == \
        jframe.decompress_frame(frame) == data


def linked_frame(blocks, block_checksum: bool = False) -> bytes:
    """A linked frame (FLG bit 5 clear) of the given (stream, stored) block
    bodies, with its content checksum over `content`."""
    flg = (1 << 6) | (int(block_checksum) << 4) | (1 << 2)
    desc = bytes([flg, 4 << 4])
    out = bytearray(struct.pack("<I", olz4.MAGIC) + desc
                    + bytes([(oxxh32.xxh32(desc) >> 8) & 0xFF]))
    for body, stored in blocks:
        out += struct.pack("<I", len(body) | (stored << 31)) + body
        if block_checksum:
            out += struct.pack("<I", oxxh32.xxh32(body))
    return bytes(out)


def hand_built():
    """Three linked blocks by hand: A stored; a block of one match 1000
    back (into A) and its literals; a block whose match reaches 1500 back,
    across the block before it into A.  -> (the blocks, the content)."""
    a = RNG.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    tail = b"tail literals!"
    b1 = (bytes([0x0F]) + struct.pack("<H", 1000) + bytes([255, 496 - 270])
          + bytes([len(tail) << 4]) + tail)
    b2 = bytes([0x36]) + b"xyz" + struct.pack("<H", 1500) + \
        bytes([0x20]) + b"ok"
    content = bytearray(a)
    for blk in (b1, b2):
        content += olz4._decompress_linked(blk, content[-65536:], 1 << 16)
    return [(a, 1), (b1, 0), (b2, 0)], bytes(content)


@pytest.mark.parametrize("block_checksum", [False, True])
def test_hand_built_linked_frame(block_checksum):
    """Matches that reach into the blocks before: read as tpuzip's oracle
    reads them; an independent read (the block mode) refuses them."""
    blocks, content = hand_built()
    frame = linked_frame(blocks, block_checksum) + struct.pack(
        "<II", 0, oxxh32.xxh32(content))
    assert jframe.decompress_frame(frame) == content
    assert tframe.decompress_frame(frame, device="cpu") == content
    indep = bytearray(frame)
    indep[4] |= 1 << 5
    with pytest.raises(ValueError):
        tframe.decompress_frame(bytes(indep), device="cpu")


def test_linked_frame_of_the_smoke():
    """chip_smoke.linked_frame's frames (liblz4's default linking: matches
    up to 64 KiB back, across blocks) read as the oracle reads them."""
    data = (SURVEY * 2)[:150_000]
    frame = chip_smoke.linked_frame(data, 1 << 16, True)
    assert jframe.decompress_frame(frame) == data
    assert tframe.decompress_frame(frame, device="cpu") == data


def test_history_mode_equals_the_oracle():
    """lz4_decode_batch's history: rows of two blocks, each after its own
    history, against _decompress_linked; a match past the history fails
    the row alone (-1, its bytes 0)."""
    text = SURVEY[:40_000]
    streams = [chip_smoke.linked_block(text[:20_000], text[20_000:28_000]),
               chip_smoke.linked_block(text[5_000:25_000],
                                       text[25_000:40_000])]
    hist = [text[:20_000], text[5_000:25_000]]
    rows = torch.zeros((2, max(map(len, streams))), dtype=torch.uint8)
    for k, st in enumerate(streams):
        rows[k, : len(st)] = torch.tensor(list(st), dtype=torch.uint8)
    lens = torch.tensor([len(st) for st in streams], dtype=torch.int32)
    h = torch.from_numpy(np.frombuffer(b"".join(hist), np.uint8).copy()
                         ).reshape(2, -1)
    out, status = lz4_coder.lz4_decode_batch(rows, lens, 1 << 14, h)
    for k, (s, hh) in enumerate(zip(streams, hist)):
        want = olz4._decompress_linked(s, bytearray(hh), 1 << 16)
        assert int(status[k]) == len(want)
        assert out[k, : len(want)].numpy().tobytes() == want
        assert not out[k, len(want):].any()
    out, status = lz4_coder.lz4_decode_batch(rows, lens, 1 << 14,
                                             h[:, 15_000:])
    assert status.tolist() == [-1, -1] and not out.any()


def with_content_size(frame: bytes, size: int) -> bytes:
    """frame with FLG bit 3 and an 8-byte content size after BD."""
    desc = bytes([frame[4] | 1 << 3, frame[5]]) + struct.pack("<Q", size)
    return (frame[:4] + desc + bytes([(oxxh32.xxh32(desc) >> 8) & 0xFF])
            + frame[7:])


def test_frame_with_content_size_and_dictionary_id():
    data = TEXT[:20_000]
    frame = with_content_size(jframe.compress_frame(data), len(data))
    assert tframe.decompress_frame(frame, device="cpu") == \
        jframe.decompress_frame(frame) == data
    dict_id = bytearray(jframe.compress_frame(data))
    dict_id[4] |= 1
    dict_id[6:6] = b"\x01\x02\x03\x04"   # after BD, before HC
    assert tframe.decompress_frame(bytes(dict_id), device="cpu") == \
        jframe.decompress_frame(bytes(dict_id)) == data


@functools.cache
def _corruptions():
    data = TEXT[:100_000]
    good = olz4.compress_frame(data, block_max=1 << 16, block_checksum=True)
    (blen,) = struct.unpack_from("<I", good, 7)
    out = {}
    bad = bytearray(good)
    bad[0] ^= 1
    out["magic"] = bytes(bad)
    bad = bytearray(good)
    bad[5] = 2 << 4
    out["bd"] = bytes(bad)
    bad = bytearray(good)
    bad[4] = (bad[4] & 0x3F) | (2 << 6)
    out["version"] = bytes(bad)
    bad = bytearray(good)
    struct.pack_into("<I", bad, 7, (1 << 16) + 1)
    out["block_past_block_max"] = bytes(bad)
    bad = bytearray(good)
    bad[7 + 4 + blen] ^= 0x55          # the first block's checksum
    out["block_checksum"] = bytes(bad)
    bad = bytearray(good)
    bad[-1] ^= 0x55
    out["content_checksum"] = bytes(bad)
    bad = bytearray(good)
    bad[7 + 4 + 20] ^= 0xFF            # inside the first block's stream
    out["block_body"] = bytes(bad)
    out["cut"] = good[:len(good) // 2]
    return out


@pytest.mark.parametrize("name", list(_corruptions()))
def test_refusals_are_tpuzips(name):
    """Each frame tpuzip's decompress_frame refuses, the port refuses with
    ValueError (where tpuzip raises struct.error on a frame cut short)."""
    frame = _corruptions()[name]
    with pytest.raises(Exception):
        jframe.decompress_frame(frame)
    with pytest.raises(ValueError):
        tframe.decompress_frame(frame, device="cpu")


def test_cuda_without_a_gpu_raises():
    with pytest.raises(RuntimeError):
        tframe.compress_frame(b"abc")
    with pytest.raises(RuntimeError):
        tframe.decompress_frame(jframe.compress_frame(b"abc"))
