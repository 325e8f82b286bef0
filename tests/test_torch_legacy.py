"""Containers without the chunk index (flag 2 clear), as tpuzip's run_job
writes them, and the top-level defaults of compress.

tpuzip writes flag-0 containers for every codec (run_job) and decodes
them: ari, bwt and bwtdc at the default knobs whatever flag 4 says, bin
and apm at the trailer's knobs.  The port decodes them the same way,
through the no-index modes of its decoders, whose plain versions are held
here against tpuzip's XLA scans (garbage streams included)."""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from tpuzip.codecs import ari as jari
from tpuzip.codecs import bin_apm as jbin
from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.runtime.checkpoint import run_job
import chip_smoke
import tpuzip_torch
from tpuzip_torch.codecs import bin_apm as tbin
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.dist import runner as trun
from tpuzip_torch.kernels import range_decoder as trd

MESH1 = meshlib.make_mesh(1)
CODECS = ("ari", "bwt", "bwtdc", "bin", "apm")
TEXT = (b"she sells sea shells by the sea shore; the shells she sells are "
        b"surely seashells. 0123456789 " * 60)


def _case(codec):
    """(data, block_size): 3 blocks, the last ragged; 512-byte blocks for
    the bit coders (the plain versions take a step a bit)."""
    if codec in ("bin", "apm"):
        return TEXT[:1400], 512
    return TEXT[:5000], 2048


@pytest.fixture(scope="module")
def legacy(tmp_path_factory):
    """codec -> (data, block_size, run_job's flag-0 container)."""
    out = {}
    for codec in CODECS:
        data, bs = _case(codec)
        work = tmp_path_factory.mktemp(f"job_{codec}")
        out[codec] = (data, bs, run_job(data, str(work), codec=codec,
                                        block_size=bs, mesh=MESH1))
    return out


@pytest.mark.parametrize("codec", CODECS)
def test_run_job_container_decodes_in_both(legacy, codec):
    data, bs, blob = legacy[codec]
    assert blob[5] == 0 and int.from_bytes(blob[10:14], "little") == 3
    assert jrun.decompress(blob, mesh=MESH1) == data
    assert tpuzip_torch.decompress(blob, device="cpu") == data


def _same_error(bad):
    with pytest.raises(Exception) as mine:
        tpuzip_torch.decompress(bad, device="cpu")
    with pytest.raises(Exception) as ref:
        jrun.decompress(bad, mesh=MESH1)
    name = type(mine.value).__name__
    assert name == type(ref.value).__name__, (mine.value, ref.value)
    return name


@pytest.mark.parametrize("codec", CODECS)
def test_run_job_corruption_raises_same_class(legacy, codec):
    """A byte flipped inside block 1's stream, and block 0 declared longer
    than the codec's bound without the index."""
    _, bs, blob = legacy[codec]
    clens = np.frombuffer(blob, "<u4", 3, 26)
    off = 26 + 12 + int(clens[0]) + int(clens[1]) // 2
    flip = bytearray(blob)
    flip[off] ^= 0x5A
    assert _same_error(bytes(flip)) in ("ChecksumError", "CorruptStreamError")
    cap = trun._block_cap(codec, 0, bs)
    big = bytearray(blob)
    big[26:30] = struct.pack("<I", cap + 1)
    big += bytes(cap + 1 - int(clens[0]))
    assert _same_error(bytes(big)) == "BlockLengthError"


def _config(codec, knobs):
    cfg = Config()
    if codec in ("bin", "apm"):
        cfg.codec.ari.bin_bits, cfg.codec.ari.bin_rate = knobs
    else:
        cfg.codec.ari.increment, cfg.codec.ari.threshold = knobs
    return cfg


@pytest.mark.parametrize("codec", CODECS)
def test_stripped_index_equals_run_job(legacy, codec):
    """The port's own container with its index stripped by the smoke's
    strip_index is run_job's container byte for byte: the legacy phase of
    chip_smoke.py decodes tpuzip's format."""
    data, bs, blob = legacy[codec]
    mine = tpuzip_torch.compress(data, codec=codec, block_size=bs,
                                 device="cpu")
    assert mine[5] == 2
    assert chip_smoke.strip_index(mine) == blob


@pytest.mark.parametrize("codec,knobs", [("ari", (16, 40000)),
                                         ("apm", (10, 4))])
def test_unindexed_knob_trailer(legacy, codec, knobs):
    """A flag-4 trailer without the index: tpuzip decodes ari at the
    default knobs whatever the trailer says, bin/apm at the trailer's, and
    the port does the same."""
    data, bs, _ = legacy[codec]
    cfg = _config(codec, knobs)
    mine = tpuzip_torch.compress(data, codec=codec, block_size=bs,
                                 device="cpu", config=config_from_dict(
                                     dataclasses.asdict(cfg)))
    bad = chip_smoke.strip_index(mine)
    assert bad[5] == 4
    if codec == "ari":
        # the stream was coded at (16, 40000): both decode at (8, 8192)
        # and fail the corpus checksum alike
        assert _same_error(bad) == "ChecksumError"
    else:
        assert jrun.decompress(bad, mesh=MESH1) == data
        assert tpuzip_torch.decompress(bad, device="cpu") == data


def _streams(rng, coder, width, sizes):
    """(comp (6, width) u8, lengths): four real streams of mixed content
    (blocks of `sizes`, the third random), one garbage row shorter than the
    width and one that fills it (so the clip to the row's last byte is
    read)."""
    rows, lens = [], []
    for i, n in enumerate(sizes):
        block = (rng.integers(0, 256, n) if i == 2 else
                 np.frombuffer(TEXT[:n], np.uint8)).astype(np.uint8)
        s = coder(block)
        rows.append(np.frombuffer(s, np.uint8))
        lens.append(n)
    rows.append(rng.integers(0, 256, width // 2).astype(np.uint8))
    rows.append(rng.integers(0, 256, width).astype(np.uint8))
    lens += [400, 700]
    comp = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        comp[i, : len(r)] = r[:width]
    return comp, np.array(lens, np.int32)


def test_ari_decode_batch_matches_tpuzip(rng):
    from tpuzip.oracle import ari as oari

    comp, lens = _streams(rng, lambda b: oari.encode_bytes(b.tobytes()),
                          jari.encode_cap(700), (0, 1, 300, 700))
    for out_n in (700, 640):
        ref = np.asarray(jari.decode_batch(comp, lens, out_n))
        got = trd.decode_batch(torch.from_numpy(comp),
                               torch.from_numpy(lens), out_n)
        assert got.shape == (6, out_n)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert bytes(got[3, :640].numpy()) == TEXT[:640]


def test_bin_decode_batch_matches_tpuzip(rng):
    """apm at (10, 4) against tpuzip's decode_batch (bin at (12, 5) runs
    in the run_job containers)."""
    for apm, (bits, rate) in ((True, (10, 4)),):
        def coder(block):
            comp, clens = jbin.encode_batch(block[None, :],
                                            np.array([block.size], np.int32),
                                            bits, rate, apm)
            return np.asarray(comp)[0, : int(clens[0])].tobytes()

        comp, lens = _streams(rng, coder, 4 * 80 + 64, (1, 20, 50, 80))
        lens = np.minimum(lens, 80)
        ref = np.asarray(jbin.decode_batch(comp, lens, 80, bits, rate, apm))
        got = tbin.decode_batch(torch.from_numpy(comp),
                                torch.from_numpy(lens), 80, bits, rate, apm)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("codec", ["ari", "bwt"])
def test_top_level_default_block_size(codec):
    """tpuzip_torch.compress mirrors tpuzip.compress's 64 KiB default;
    bytes are held against the runner on a one-device mesh (tpuzip.compress
    pads the batch to the 8-device test mesh)."""
    import tpuzip

    data = TEXT[:3000]
    mine = tpuzip_torch.compress(data, codec=codec, device="cpu")
    assert mine == jrun.compress(data, codec=codec, block_size=1 << 16,
                                 mesh=MESH1)
    ref = tpuzip.compress(data, codec=codec)
    assert struct.unpack_from("<I", mine, 6) == \
        struct.unpack_from("<I", ref, 6) == (1 << 16,)
