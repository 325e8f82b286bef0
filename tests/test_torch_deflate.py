"""The deflate codec (id 5): tpuzip's C++ encoder (``tpz_deflate``, through
``native.deflate_batch_native``) and its inflate against the port's
kernels/deflate_coder.py, whose plain versions run here on the CPU; the
CUDA kernels of csrc/deflate_encode.cu and csrc/inflate.cu are held
against them on the card by chip_smoke.py."""

import dataclasses
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

import tpuzip
from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.runtime import native
import tpuzip_torch
from tpuzip_torch.core import blocks as blk
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.dist import runner as trun
from tpuzip_torch.runtime.errors import BlockLengthError, ChecksumError

MESH1 = meshlib.make_mesh(1)
with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()


def _corpus(n: int) -> bytes:
    """Text, runs over 258 bytes, random bytes, zeros and a 13-byte tail,
    in blocks of n."""
    rng = np.random.default_rng(15)
    runs = np.repeat(rng.integers(0, 256, n), rng.integers(1, 700, n))[:n]
    return (TEXT[:n] + runs.astype(np.uint8).tobytes()
            + rng.integers(0, 256, n, np.uint8).tobytes() + bytes(n)
            + TEXT[n : n + 13])


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here, as in the lz4 family's
    tests: beside the other pytest-xdist workers the plain versions' small
    ops otherwise wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mode="dynamic", max_chain=128, increment=8):
    cfg = Config()
    cfg.codec.deflate.mode = mode
    cfg.codec.deflate.max_chain = max_chain
    cfg.codec.ari.increment = increment
    return cfg


def _payloads(blob: bytes):
    """Each block's stream of a deflate container (flag 0 or 4)."""
    nb = struct.unpack_from("<I", blob, 10)[0]
    clens = np.frombuffer(blob, "<u4", nb, 26)
    off = 26 + 4 * nb + (4 * nb if blob[5] & 1 else 0) + (
        6 if blob[5] & 4 else 0)
    out = []
    for n in clens:
        out.append(blob[off : off + int(n)])
        off += int(n)
    return out


def _both(data, cfg, block_size, block_checksums=False):
    """Both packages' containers at cfg, held equal, each decoded by the
    other package, every block a stream that zlib inflates."""
    assert native.available()
    mine = tpuzip_torch.compress(
        data, codec="deflate", block_size=block_size, device="cpu",
        config=config_from_dict(dataclasses.asdict(cfg)),
        block_checksums=block_checksums)
    ref = jrun.compress(data, codec="deflate", block_size=block_size,
                        mesh=MESH1, config=cfg,
                        block_checksums=block_checksums)
    assert mine == ref, (len(data), dataclasses.asdict(cfg.codec.deflate))
    assert tpuzip_torch.decompress(ref, device="cpu") == data
    assert jrun.decompress(mine, mesh=MESH1) == data
    blocks, lens = blk.chunk(data, block_size)
    for i, stream in enumerate(_payloads(mine)):
        assert zlib.decompress(stream, -15) == \
            blocks[i, : lens[i]].tobytes()
    return mine


@pytest.mark.parametrize("block_size", [2048, 4096])
@pytest.mark.parametrize("max_chain", [1, 8, 128])
@pytest.mark.parametrize("mode", ["dynamic", "fixed", "stored"])
def test_container_identical(mode, max_chain, block_size):
    """Byte-identical containers on text, runs, random, zero and 13-byte
    blocks, in each block type and at each chain depth."""
    _both(_corpus(block_size), _cfg(mode, max_chain), block_size)


def test_edge_rows_container_identical():
    """Empty, 1-, 2- and 3-byte corpora; all-zero blocks (matches of 258);
    random blocks (no match: one distance length); max_chain 0 (no match
    at all); a 40 KiB block whose repeats lie 32,767 to 32,769 bytes back
    (the window's edge); 128 KiB stored blocks (65,535 + 65,535 + 2)."""
    for data in (b"", b"a", b"ab", b"abc"):
        for mode in ("dynamic", "fixed", "stored"):
            _both(data, _cfg(mode), 4096)
    rng = np.random.default_rng(4)
    _both(bytes(9000) + rng.integers(0, 256, 5000, np.uint8).tobytes(),
          _cfg(), 4096)
    _both(_corpus(2048), _cfg(max_chain=0), 2048)
    far = rng.integers(0, 256, 40 << 10, np.uint8)
    for k, gap in enumerate((32767, 32768, 32769)):
        at = 33000 + 1000 * k
        far[at : at + 300] = far[at - gap : at - gap + 300]
    _both(far.tobytes(), _cfg(max_chain=8), 40 << 10)
    _both(TEXT[:4000] * 33, _cfg("stored"), 1 << 17)


def test_knobs_and_checksums_ride_the_container():
    """The ari knobs set flag 4 and the trailer for deflate too (tpuzip's
    rule, hazard (r)), and block checksums flag 1; a mode outside
    dynamic/fixed/stored raises ValueError in both packages."""
    data = _corpus(2048)[:5000]
    blob = _both(data, _cfg(increment=16), 2048, block_checksums=True)
    assert blob[5] == 5
    for pkg in (lambda c: tpuzip_torch.compress(
                    data, codec="deflate", device="cpu",
                    config=config_from_dict(dataclasses.asdict(c))),
                lambda c: jrun.compress(data, codec="deflate", mesh=MESH1,
                                        config=c)):
        with pytest.raises(ValueError, match="deflate.mode"):
            pkg(_cfg("huffman"))


def test_corpus_and_to_device():
    """compress_corpus with TPZC both ways, and decompress(to_device=True)
    on the CPU."""
    assert native.available()
    data = _corpus(2048)[:7000]
    cfg = _cfg(max_chain=8)
    mine = tpuzip_torch.compress_corpus(
        data, codec="deflate", block_size=2048, superbatch=4096,
        device="cpu", config=config_from_dict(dataclasses.asdict(cfg)))
    ref = jrun.compress_corpus(data, codec="deflate", block_size=2048,
                               superbatch=4096, mesh=MESH1, config=cfg)
    assert mine == ref
    assert tpuzip_torch.decompress(ref, device="cpu") == data
    assert tpuzip.decompress(mine) == data
    blob = jrun.compress(data, codec="deflate", block_size=2048, mesh=MESH1)
    out, olens, orig = tpuzip_torch.decompress(blob, device="cpu",
                                               to_device=True)
    blocks, lens = blk.chunk(data, 2048)
    assert np.array_equal(out.numpy(), blocks) and orig == len(data)
    assert olens.tolist() == lens.tolist()


def test_decodes_tpuzips_device_container():
    """tpuzip's compress_from_device writes its device deflate rule
    (another parse and other code lengths than its C++ encoder's); the port
    decodes it, and its own compress_from_device writes the same bytes
    (tests/test_torch_deflate_xla.py)."""
    data = TEXT[:4096 * 2 + 500]
    blocks, lens = blk.chunk(data, 4096)
    blob = jrun.compress_from_device(jax.numpy.asarray(blocks), lens,
                                     "deflate", mesh=MESH1)
    assert blob[4] == 5
    assert tpuzip_torch.decompress(blob, device="cpu") == data
    out, _, _ = tpuzip_torch.decompress(blob, device="cpu", to_device=True)
    assert np.array_equal(out.numpy(), blocks)
    assert tpuzip_torch.compress_from_device(blocks, lens, codec="deflate",
                                             device="cpu") == blob


def _refusals(mine: bytes):
    """(the port's exception class, tpuzip's) on a container."""
    got = []
    for decode in (lambda c: trun.decompress(c, device="cpu"),
                   lambda c: jrun.decompress(c, mesh=MESH1)):
        try:
            decode(mine)
            got.append(None)
        except Exception as e:   # noqa: BLE001 - the class is the result
            got.append(type(e).__name__)
    return got


def test_corruption_raises_same_class():
    """A flipped payload byte raises ValueError in both packages (deflate's
    rule: a block whose status is not its length, a corrupt stream
    included); a block sum or the corpus sum, a truncated container and a
    block past the codec's bound raise tpuzip's classes.  No case codes a
    match under an empty distance table (hazard (y))."""
    data = _corpus(2048)[:6000]
    blob = bytearray(_both(data, _cfg(), 2048, block_checksums=True))
    off = 26 + 8 * 3
    seen = set()
    for k in range(0, len(blob) - off, 37):
        bad = bytearray(blob)
        bad[off + k] ^= 0x5A
        mine, ref = _refusals(bytes(bad))
        assert mine == ref, k
        seen.add(mine)
    assert {"ValueError", "CorruptStreamError"} <= seen, seen
    fixed = bytearray(_both(data, _cfg("fixed"), 2048))
    fixed[-3] ^= 0x40
    mine, ref = _refusals(bytes(fixed))
    assert mine == ref and mine in ("ValueError", "ChecksumError")
    with pytest.raises(BlockLengthError):
        tpuzip_torch.decompress(bytes(blob[:-1]), device="cpu")
    big = bytearray(blob)
    struct.pack_into("<I", big, 26, 2 * 2048 + 2049)
    assert _refusals(bytes(big)) == ["BlockLengthError"] * 2
    a32 = bytearray(_both(b"abc" * 50, _cfg(), 2048))
    a32[22] ^= 1
    with pytest.raises(ChecksumError):
        tpuzip_torch.decompress(bytes(a32), device="cpu")


def test_cuda_wrappers_refuse_without_gpu(monkeypatch):
    """device="cuda" with deflate raises where no GPU is usable: no
    fallback to the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tpuzip_torch.compress(b"abc", codec="deflate")
    blob = tpuzip_torch.compress(b"abc", codec="deflate", device="cpu")
    with pytest.raises(RuntimeError):
        tpuzip_torch.decompress(blob, device="cuda")
