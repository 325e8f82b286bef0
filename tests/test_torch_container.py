"""tpz ari containers: tpuzip_torch against tpuzip.

On the CPU the port runs its plain versions, never tpuzip's C++ coder, so
container parity here exercises the port's own code.  tpuzip runs on a
one-device mesh, because on the tests' 8-device mesh it pads the batch
with empty blocks (the port must still decode those containers).  The
CUDA kernels are held against the plain versions on the card by
chip_smoke.py."""

import zlib

import numpy as np
import pytest
import torch

from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.runtime.errors import (BlockLengthError, ChecksumError,
                                   CorruptStreamError, HeaderError)
import tpuzip_torch
from tpuzip_torch import device as tdevice
from tpuzip_torch.core.checksum import adler32_batch
from tpuzip_torch.kernels import _build

MESH1 = meshlib.make_mesh(1)


def _small(samples):
    return [s for s in samples if len(s) <= 4096]


def _config(inc, thr):
    cfg = Config()
    cfg.codec.ari.increment, cfg.codec.ari.threshold = inc, thr
    return cfg


def _round_trip_both(data, block_size, cfg, checksums):
    mine = tpuzip_torch.compress(data, block_size=block_size, device="cpu",
                                 config=cfg, block_checksums=checksums)
    ref = jrun.compress(data, codec="ari", block_size=block_size, mesh=MESH1,
                        config=cfg, block_checksums=checksums)
    assert mine == ref, (len(data), block_size, checksums)
    assert tpuzip_torch.decompress(ref, device="cpu") == data
    assert jrun.decompress(mine, mesh=MESH1) == data
    return mine


@pytest.mark.parametrize("block_size", [256, 4096])
@pytest.mark.parametrize("checksums", [False, True])
def test_container_identical_default_knobs(samples, block_size,
                                          checksums):
    for data in _small(samples):
        blob = _round_trip_both(data, block_size, None, checksums)
        assert blob[5] == 2 | int(checksums)


@pytest.mark.parametrize("knobs", [(8, 512), (16, 40000)],
                         ids=lambda k: f"inc{k[0]}-thr{k[1]}")
def test_container_identical_knob_trailer(samples, knobs):
    """Non-default knobs ride the flag-4 <HI> trailer; (16, 40000) is past
    the 2^15 bound where tpuzip leaves its packed kernels."""
    cases = [s for s in _small(samples) if len(s) >= 1000] + [b""]
    for i, data in enumerate(cases):
        blob = _round_trip_both(data, 4096 if i % 2 else 256,
                                _config(*knobs), checksums=i % 3 == 0)
        assert blob[5] & 4


def test_decodes_mesh_padded_container(rng):
    """tpuzip on the 8-device test mesh pads 4 blocks to 8 empty-tailed
    ones; each padding block still carries idx_len and 4 finish bytes."""
    data = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    blob = jrun.compress(data, codec="ari", block_size=256,
                         mesh=meshlib.make_mesh(8))
    assert int.from_bytes(blob[10:14], "little") == 8
    assert tpuzip_torch.decompress(blob, device="cpu") == data


def _mutations(blob, checksums):
    nb = int.from_bytes(blob[10:14], "little")
    off = 26 + 4 * nb + (4 * nb if checksums else 0)
    c0 = int.from_bytes(blob[26:30], "little")
    idx0 = int.from_bytes(blob[off : off + 4], "little")

    def put_idxlen(v):
        return blob[:off] + v.to_bytes(4, "little") + blob[off + 4:]

    flip = bytearray(blob)
    flip[off + 4 + idx0 + c0 // 2] ^= 0x5A     # inside block 0's stream
    return {
        "magic": b"XPZ1" + blob[4:],
        "codec id": blob[:4] + b"\xee" + blob[5:],
        "truncated header": blob[:20],
        "truncated length table": blob[: 26 + 2],
        "truncated checksum table": blob[: 26 + 4 * nb + 2],
        "trailing byte": blob + b"\x00",
        "short payload": blob[:-1],
        "index overruns payload": put_idxlen(c0),
        "index truncated": put_idxlen(idx0 - 1),
        "stream byte": bytes(flip),
    }


EXPECTED = {
    "magic": HeaderError, "codec id": HeaderError,
    "truncated header": HeaderError,
    "truncated length table": BlockLengthError,
    "trailing byte": BlockLengthError, "short payload": BlockLengthError,
    "index overruns payload": BlockLengthError,
    "index truncated": CorruptStreamError,
}


@pytest.mark.parametrize("checksums", [False, True])
def test_corruption_raises_same_class(rng, checksums):
    data = (b"the quick brown fox jumps over the lazy dog " * 30)[:1000]
    blob = tpuzip_torch.compress(data, block_size=256, device="cpu",
                                 block_checksums=checksums)
    for name, bad in _mutations(blob, checksums).items():
        if name == "truncated checksum table" and not checksums:
            continue
        with pytest.raises(Exception) as mine:
            tpuzip_torch.decompress(bad, device="cpu")
        with pytest.raises(Exception) as ref:
            jrun.decompress(bad, mesh=MESH1)
        assert type(mine.value) is type(ref.value), name
        exp = EXPECTED.get(name, BlockLengthError)
        if name == "stream byte":   # per-block sums name the block first
            exp = CorruptStreamError if checksums else ChecksumError
        assert type(mine.value) is exp, (name, mine.value)


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdevice.resolve("cuda")
    with pytest.raises(RuntimeError):
        tpuzip_torch.compress(b"abc")
    blob = tpuzip_torch.compress(b"abc", device="cpu")
    with pytest.raises(RuntimeError):
        tpuzip_torch.decompress(blob, device="cuda")
    assert tdevice.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve("meta")


def test_unported_entry_points_name_the_roadmap():
    calls = [lambda: tpuzip_torch.compress(b"x", codec="lz4", device="cpu"),
             lambda: tpuzip_torch.compress(b"x", codec="bwt", device="cpu"),
             lambda: tpuzip_torch.compress_corpus(b"x"),
             lambda: tpuzip_torch.decompress_corpus(b"TPZC"),
             lambda: tpuzip_torch.decompress(b"TPZC" + bytes(30), "cpu"),
             lambda: tpuzip_torch.compress_from_device(None, None),
             lambda: tpuzip_torch.open(None)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
    lz4 = jrun.compress(b"abc" * 100, codec="lz4", mesh=MESH1)
    with pytest.raises(NotImplementedError, match="item 12"):
        tpuzip_torch.decompress(lz4, device="cpu")
    with pytest.raises(ValueError):
        tpuzip_torch.compress(b"x", codec="zstd", device="cpu")


def test_adler32_batch_matches_zlib(rng):
    import jax.numpy as jnp

    from tpuzip.core.checksum import adler32_batch as jadler

    n = 5000
    blocks = rng.integers(0, 256, (6, n), dtype=np.uint8)
    blocks[1] = 255
    lens = np.array([n, n, 0, 1, 4097, 3333], np.int32)
    got = adler32_batch(torch.from_numpy(blocks), torch.from_numpy(lens))
    exp = [zlib.adler32(blocks[i, : lens[i]].tobytes()) for i in range(6)]
    assert got.tolist() == exp
    np.testing.assert_array_equal(
        np.asarray(jadler(jnp.array(blocks), jnp.array(lens))), exp)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cu").write_text("this is not C++\n")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'broken.cu(1): error: expected a "
                    "declaration' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="expected a declaration"):
        _build.load("broken")
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()

