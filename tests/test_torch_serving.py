"""Device-resident serving and the corpus API: tpuzip_torch's
compress_from_device, decompress(to_device=True), compress_corpus and
decompress_corpus against tpuzip's, on the CPU (the port's plain versions;
tpuzip's runner on a one-device mesh), and the corpus Adler-32."""

import dataclasses
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

import tpuzip
from tpuzip.codecs import rle as jrle
from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.runtime import native
from tpuzip.runtime.errors import TpzError
import tpuzip_torch
from tpuzip_torch.core import blocks as blk
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.dist import runner as trun
from tpuzip_torch.kernels import rle_coder
from tpuzip_torch.oracle import adler as oadler
from tpuzip_torch.runtime.errors import HeaderError

MESH1 = meshlib.make_mesh(1)
with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()
# block sizes a codec's plain coder takes in a few seconds here
BLOCK = {"lz4": 4096, "rle": 4096, "ari": 512, "bwt": 512, "bwtdc": 512,
         "bin": 128, "apm": 128}
CODECS = list(BLOCK)


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


def _cfg(inc=8, thr=1 << 13):
    cfg = Config()
    cfg.codec.ari.increment, cfg.codec.ari.threshold = inc, thr
    return cfg


def _mine(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _device_rows(codec, nblocks=3, tail=100):
    """(blocks, lengths): nblocks - 1 full blocks of text and a last one of
    `tail` bytes whose bytes past its length are random (the caller's)."""
    n = BLOCK[codec]
    data = TEXT[: (nblocks - 1) * n + tail]
    blocks, lens = blk.chunk(data, n)
    blocks[-1, tail:] = np.random.default_rng(3).integers(0, 256, n - tail)
    return blocks, lens, data


def _both_from_device(codec, checksums=False, cfg=None, rows=None):
    blocks, lens, data = rows or _device_rows(codec)
    mine = tpuzip_torch.compress_from_device(
        torch.from_numpy(blocks), torch.from_numpy(lens), codec=codec,
        block_checksums=checksums, config=cfg and _mine(cfg), device="cpu")
    ref = jrun.compress_from_device(blocks, lens, codec=codec, mesh=MESH1,
                                    block_checksums=checksums, config=cfg)
    assert mine == ref, (codec, checksums)
    return mine, data


@pytest.mark.parametrize("checksums", [False, True], ids=["plain", "sums"])
@pytest.mark.parametrize("codec", CODECS)
def test_from_device_container_identical(codec, checksums):
    """compress_from_device's container is tpuzip's byte for byte (lz4:
    tpuzip's device encoder at hash_log 15; rle: its 256-byte segments;
    bin, apm: the stream alone, flag 2 clear); each package decodes the
    other's, and decompress(to_device=True) returns tpuzip's blocks,
    olens and orig_len."""
    blob, data = _both_from_device(codec, checksums)
    assert blob[5] & 1 == checksums
    assert blob[5] & 2 == (0 if codec in ("lz4", "rle", "bin", "apm") else 2)
    assert tpuzip_torch.decompress(blob, device="cpu") == data
    assert jrun.decompress(blob, mesh=MESH1) == data
    out, olens, orig = tpuzip_torch.decompress(blob, device="cpu",
                                               to_device=True)
    ref, ref_olens, ref_orig = jrun.decompress(blob, mesh=MESH1,
                                               to_device=True)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(olens, ref_olens)
    assert olens.dtype == np.int64 and orig == ref_orig == len(data)


@pytest.mark.parametrize("codec", ["lz4", "rle", "ari", "bwt", "bwtdc"])
def test_from_device_knob_trailer(codec):
    """ari knobs other than (8, 8192) set flag 4 and the trailer for every
    codec but bin and apm, as in tpuzip; each package decodes the other's."""
    blob, data = _both_from_device(codec, cfg=_cfg(16, 512))
    assert blob[5] & 4
    assert tpuzip_torch.decompress(blob, device="cpu") == data
    assert jrun.decompress(blob, mesh=MESH1) == data


@pytest.mark.parametrize("codec", ["bin", "apm"])
def test_bin_knob_trailer_refused(codec):
    """Fault 2: tpuzip keys bin/apm's flag 4 on the ari knobs but encodes at
    (12, 5), so its own container decodes with the wrong model; the port
    refuses to write it."""
    blocks, lens, data = _device_rows(codec)
    cfg = _cfg(16, 512)
    with pytest.raises(ValueError, match="trailer"):
        tpuzip_torch.compress_from_device(blocks, lens, codec=codec,
                                          config=_mine(cfg), device="cpu")
    ref = jrun.compress_from_device(blocks, lens, codec=codec, mesh=MESH1,
                                    config=cfg)
    assert ref[5] & 4
    try:
        back = jrun.decompress(ref, mesh=MESH1)
    except (TpzError, ValueError):
        return
    assert back != data


def test_from_device_bwt_segmented(monkeypatch):
    """flag 8 past SEG_THRESHOLD (2048 in both runners) on rows of 4096."""
    monkeypatch.setattr(trun, "SEG_THRESHOLD", 2048)
    monkeypatch.setattr(jrun, "SEG_THRESHOLD", 2048)
    data = TEXT[:4096 + 700]
    blocks, lens = blk.chunk(data, 4096)
    blob, _ = _both_from_device("bwt", rows=(blocks, lens, data))
    assert blob[5] & 8
    assert tpuzip_torch.decompress(blob, device="cpu") == data
    assert jrun.decompress(blob, mesh=MESH1) == data


def test_from_device_checks_its_input():
    """No block, a short block before the last, a last length past n or a
    tensor on another device raise ValueError; deflate (tpuzip's device
    rule, tests/test_torch_deflate_xla.py) and lz4p
    (tests/test_torch_lz4p.py) give tpuzip's containers."""
    blocks, lens, _ = _device_rows("lz4")
    call = tpuzip_torch.compress_from_device
    with pytest.raises(ValueError, match="at least one"):
        call(np.zeros((0, 64), np.uint8), [], device="cpu")
    for bad in ([4096, 100, 100], [4096, 4096, 4097], [4096, 4096, -1]):
        with pytest.raises(ValueError, match="full blocks"):
            call(blocks, bad, device="cpu")
    with pytest.raises(ValueError, match="no silent copy"):
        call(torch.from_numpy(blocks).to("meta"), lens, device="cpu")
    with pytest.raises(TypeError):
        call(blocks.astype(np.int32), lens, device="cpu")
    for codec in ("deflate", "lz4p"):
        assert call(blocks, lens, codec=codec, device="cpu") == \
            jrun.compress_from_device(jax.numpy.asarray(blocks), lens, codec,
                                      mesh=MESH1)
    with pytest.raises(RuntimeError):
        call(blocks, lens)                    # cuda, and there is no GPU
    one = call(blocks[:1, :0].copy(), [0], device="cpu")
    assert tpuzip_torch.decompress(one, device="cpu") == b""


def test_plain_rle_segments_equal_xla():
    """rle_encode_segments_batch's plain version against tpuzip's XLA
    encoder: runs of 255 to 257, 511, 512, 513 and 3, text, 4 symbols,
    a row with random bytes past its length, lengths 0 and 1."""
    rng = np.random.default_rng(8)
    n = 4096
    runs = np.concatenate([np.full(r, v) for v, r in zip(
        range(1, 100), [255, 256, 257, 511, 512, 513, 3, 1, 2, 1024] * 9)])
    rows = [runs[:n], np.frombuffer(TEXT[:n], np.uint8), rng.integers(0, 4, n),
            rng.integers(0, 256, n), np.full(n, 9), runs[n : 2 * n],
            np.frombuffer(TEXT[n : 2 * n], np.uint8)]
    rows = np.stack(rows).astype(np.uint8)
    lens = np.array([n, n, n, 3000, 0, 1, 2222], np.int32)
    comp, clens = rle_coder.rle_encode_segments_batch(
        torch.from_numpy(rows), torch.from_numpy(lens))
    ref, ref_lens = jax.jit(jrle.encode_batch)(rows, lens)
    ref, ref_lens = np.asarray(ref), np.asarray(ref_lens)
    np.testing.assert_array_equal(clens.numpy(), ref_lens)
    for r in range(len(lens)):
        assert comp[r, : clens[r]].numpy().tobytes() == \
            ref[r, : ref_lens[r]].tobytes()
    assert not comp.numpy()[np.arange(comp.shape[1])[None, :]
                            >= clens.numpy()[:, None]].any()
    out, status = rle_coder.rle_decode_batch(comp, clens, n)
    np.testing.assert_array_equal(status.numpy(), lens)


@pytest.mark.parametrize("superbatch", [96 * 1024, None],
                         ids=["96KiB", "blocks_per_chip"])
def test_corpus_container_identical(superbatch):
    """compress_corpus against tpuzip's on a one-device mesh (superbatch
    None: config.mesh.blocks_per_chip blocks); each package decodes the
    other's, and the top-level decompress reads TPZC.  tpuzip's C++ coder
    is loaded first: its lazy load is not thread-safe (native.get_lib sets
    _tried before _lib), so a cold compress_corpus lets one superbatch
    fall back to the XLA encoder, whose lz4 bytes differ."""
    assert native.available()
    data = (TEXT * 4)[:100_000]
    mine = tpuzip_torch.compress_corpus(data, block_size=4096,
                                        superbatch=superbatch, device="cpu")
    ref = jrun.compress_corpus(data, block_size=4096, superbatch=superbatch,
                               mesh=MESH1)
    assert mine == ref
    # None: blocks_per_chip (8) blocks of 4096
    assert struct.unpack_from("<I", mine, 4)[0] == (2 if superbatch else 4)
    assert tpuzip_torch.decompress(ref, device="cpu") == data
    assert tpuzip_torch.decompress_corpus(ref, device="cpu") == data
    assert tpuzip.decompress(mine) == data


@pytest.mark.parametrize("codec", ["rle", "ari"])
def test_corpus_small_and_empty(codec):
    """Tiny and empty corpora, another codec and block checksums: empty
    input is one empty superbatch."""
    for data in (b"", b"x", TEXT[:2500]):
        mine = tpuzip_torch.compress_corpus(
            data, codec=codec, block_size=512, superbatch=1024,
            block_checksums=True, device="cpu")
        ref = jrun.compress_corpus(data, codec=codec, block_size=512,
                                   superbatch=1024, block_checksums=True,
                                   mesh=MESH1)
        assert mine == ref
        assert tpuzip_torch.decompress(mine, device="cpu") == data
    assert struct.unpack_from("<I", mine, 4)[0] == 3


def test_corpus_threads_agree():
    """Twenty superbatches on 16 threads (more than the cores), with a short
    switch interval, give the serial blob, and decode on 16 threads too."""
    import sys

    data = (TEXT * 2)[:40_000]
    serial = tpuzip_torch.compress_corpus(data, block_size=1024,
                                          superbatch=2048, pipeline=1,
                                          device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        wide = tpuzip_torch.compress_corpus(data, block_size=1024,
                                            superbatch=2048, pipeline=16,
                                            device="cpu")
        back = tpuzip_torch.decompress_corpus(wide, pipeline=16,
                                              device="cpu")
    finally:
        sys.setswitchinterval(old)
    assert wide == serial and back == data


def test_corpus_rejects_bad_blobs():
    """A truncated blob, trailing bytes and a foreign magic raise
    ValueError (tpuzip's too, but for a blob cut inside its count, where it
    raises struct.error); runner.decompress refuses TPZC as a tpz
    container, as tpuzip's runner does; to_device takes no TPZC."""
    blob = tpuzip_torch.compress_corpus(TEXT[:3000], superbatch=1024,
                                        device="cpu")
    for bad in (blob[:-1], blob[:6], blob[:20], blob + b"\x00"):
        with pytest.raises(ValueError):
            tpuzip_torch.decompress_corpus(bad, device="cpu")
        with pytest.raises(ValueError if len(bad) > 8 else struct.error):
            jrun.decompress_corpus(bad)
    with pytest.raises(ValueError, match="not a tpz corpus"):
        tpuzip_torch.decompress_corpus(b"TPZ1" + blob[4:], device="cpu")
    with pytest.raises(HeaderError, match="bad tpz magic"):
        trun.decompress(blob, device="cpu")
    with pytest.raises(ValueError, match="to_device"):
        tpuzip_torch.decompress(blob, device="cpu", to_device=True)


@pytest.mark.parametrize("size", [(8 << 20) - 1, 8 << 20, (8 << 20) + 3],
                         ids=["8MiB-1", "8MiB", "8MiB+3"])
def test_corpus_adler32_equals_zlib(size):
    """Below 8 MiB one zlib.adler32; from there 4 parts in threads folded by
    oracle.adler.combine (a copy of tpuzip's), equal to zlib.adler32 and
    to tpuzip's corpus_adler32."""
    data = np.random.default_rng(size).integers(0, 256, size,
                                                np.uint8).tobytes()
    got = trun.corpus_adler32(data)
    assert got == zlib.adler32(data) == jrun.corpus_adler32(data)
    a, b = data[:1000], data[1000:5000]
    assert oadler.combine(zlib.adler32(a), zlib.adler32(b), len(b)) == \
        zlib.adler32(a + b) == oadler.adler32(a + b)
