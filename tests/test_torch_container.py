"""tpz ari, bwt, bwtdc, bin and apm containers: tpuzip_torch against
tpuzip.

On the CPU the port runs its plain versions (torch BWT and DC, plain MTF,
ari, DC walk and bin coder), never tpuzip's C++ coder, so container parity
here exercises the port's own code.  tpuzip runs on a one-device mesh,
because on the tests' 8-device mesh it pads the batch with empty blocks
(the port must still decode those containers).  The CUDA kernels are
held against the plain versions on the card by chip_smoke.py."""

import dataclasses
import io
import struct
import zlib

import numpy as np
import pytest
import torch

from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.runtime import native
import tpuzip
import tpuzip_torch
from tpuzip_torch import device as tdevice
from tpuzip_torch.core.checksum import adler32_batch
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.dist import runner as trun
from tpuzip_torch.kernels import _build

MESH1 = meshlib.make_mesh(1)


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


def _small(samples):
    return [s for s in samples if len(s) <= 4096]


def _config(inc, thr):
    cfg = Config()
    cfg.codec.ari.increment, cfg.codec.ari.threshold = inc, thr
    return cfg


def _bin_config(bits, rate):
    cfg = Config()
    cfg.codec.ari.bin_bits, cfg.codec.ari.bin_rate = bits, rate
    return cfg


def _round_trip_both(data, block_size, cfg, checksums, codec="ari"):
    """Both packages' containers are equal, and each decodes the other's;
    the port gets the tpuzip config carried across (config_from_dict)."""
    mine_cfg = cfg and config_from_dict(dataclasses.asdict(cfg))
    mine = tpuzip_torch.compress(data, codec=codec, block_size=block_size,
                                 device="cpu", config=mine_cfg,
                                 block_checksums=checksums)
    ref = jrun.compress(data, codec=codec, block_size=block_size, mesh=MESH1,
                        config=cfg, block_checksums=checksums)
    assert mine == ref, (codec, len(data), block_size, checksums)
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
    ones; each padding block still carries idx_len and 4 finish bytes (and
    a bwt one its origin)."""
    data = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    for codec in ("ari", "bwt", "bwtdc", "bin", "apm"):
        blob = jrun.compress(data, codec=codec, block_size=256,
                             mesh=meshlib.make_mesh(8))
        assert int.from_bytes(blob[10:14], "little") == 8
        assert tpuzip_torch.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("block_size", [1024, 4096])
@pytest.mark.parametrize("checksums", [False, True])
def test_bwt_container_identical(samples, block_size, checksums):
    """BWT -> MTF -> ari, flag 2: empty, length-1, ragged, periodic and
    constant blocks among the samples."""
    for data in _small(samples):
        blob = _round_trip_both(data, block_size, None, checksums, "bwt")
        assert blob[4] == trun.CODECS["bwt"] and blob[5] == 2 | int(checksums)


def test_bwt_container_knob_trailer(samples):
    cases = [s for s in _small(samples) if len(s) >= 1000] + [b""]
    for i, data in enumerate(cases):
        blob = _round_trip_both(data, 1024, _config(8, 512), i % 2 == 0,
                                "bwt")
        assert blob[5] & 4


def _bwtdc_cases(samples):
    """Empty, length 1, random (4 blocks of 1024, the last ragged),
    constant, periodic and text samples."""
    return [s for s in _small(samples) if len(s) in (0, 1, 255, 1000, 1200,
                                                     2816, 4096)]


@pytest.mark.parametrize("block_size", [1024, 2048])
def test_bwtdc_container_identical(samples, block_size):
    """BWT -> DC -> ari, flag 2; block_checksums on every other sample."""
    for i, data in enumerate(_bwtdc_cases(samples)):
        blob = _round_trip_both(data, block_size, None, i % 2 == 1, "bwtdc")
        assert blob[4] == trun.CODECS["bwtdc"]
        assert blob[5] == 2 | (i % 2)


def test_bwtdc_container_knob_trailer(samples):
    cases = [s for s in _bwtdc_cases(samples) if len(s) >= 1000] + [b""]
    for i, data in enumerate(cases):
        blob = _round_trip_both(data, 1024, _config(16, 40000), i % 2 == 0,
                                "bwtdc")
        assert blob[5] & 4


def _bin_cases(samples):
    """Empty, length 1 and 7, random (4 blocks of 256, the last ragged),
    constant and text samples."""
    return [s for s in _small(samples) if len(s) in (0, 1, 7, 1000, 2816)]


@pytest.mark.parametrize("codec", ["bin", "apm"])
def test_bin_container_identical(samples, codec):
    """Default knobs (12, 5), flag 2, 256-bit chunk index; block_checksums
    on every other sample."""
    for i, data in enumerate(_bin_cases(samples)):
        blob = _round_trip_both(data, 256, None, i % 2 == 0, codec)
        assert blob[4] == trun.CODECS[codec] and blob[5] == 2 | (i % 2 == 0)


@pytest.mark.parametrize("knobs", [(10, 4), (11, 5)],
                         ids=lambda k: f"bits{k[0]}-rate{k[1]}")
def test_bin_container_knob_trailer(samples, knobs):
    """(bin_bits, bin_rate) other than (12, 5) ride the flag-4 trailer."""
    cases = [s for s in _bin_cases(samples) if len(s) in (7, 1000)]
    for codec in ("bin", "apm"):
        for i, data in enumerate(cases):
            blob = _round_trip_both(data, 256, _bin_config(*knobs), i == 0,
                                    codec)
            nb = int.from_bytes(blob[10:14], "little")
            off = 26 + 4 * nb * (2 if i == 0 else 1)
            assert blob[5] & 4 and struct.unpack_from("<HI", blob, off) == \
                knobs


def _segment_above(monkeypatch, threshold=2048):
    """Both runners segment bwt blocks above `threshold` bytes (1 MiB in
    both packages otherwise); the geometry depends on the block size
    alone, so the containers decode unpatched."""
    monkeypatch.setattr(trun, "SEG_THRESHOLD", threshold)
    monkeypatch.setattr(jrun, "SEG_THRESHOLD", threshold)


def test_bwt_segmented_container_identical(samples, monkeypatch):
    """Flag 8 at block_size 4096: 16 segments of 256, each MTF+ari coded
    with fresh state."""
    _segment_above(monkeypatch)
    assert trun._seg_geometry(4096) == jrun._seg_geometry(4096) == (256, 16)
    blobs = {}
    for i, data in enumerate(s for s in samples if len(s) <= 8192):
        blobs[data] = _round_trip_both(data, 4096, None, i % 2 == 1, "bwt")
        assert blobs[data][5] & 8
    monkeypatch.undo()
    for data, blob in blobs.items():
        assert tpuzip_torch.decompress(blob, device="cpu") == data
        assert jrun.decompress(blob, mesh=MESH1) == data


def _with_payload(blob, payload):
    """A one-block container (no checksum or knob tables) with its payload
    replaced and the length table set to match."""
    assert int.from_bytes(blob[10:14], "little") == 1 and not blob[5] & 5
    return blob[:26] + struct.pack("<I", len(payload)) + payload


BWT_CORRUPTIONS = {   # name: (segmented, payload -> payload, class name)
    "shorter than header": (False, lambda p: p[:6], "BlockLengthError"),
    "index overruns payload": (False, lambda p: p[:4] + struct.pack(
        "<I", len(p)) + p[8:], "BlockLengthError"),
    "wrong nseg": (True, lambda p: p[:4] + struct.pack("<H", 15) + p[6:],
                   "CorruptStreamError"),
    "segment longer than seg": (True, lambda p: p[:10] + struct.pack(
        "<I", 257) + p[14:], "CorruptStreamError"),
    "segment truncated": (True, lambda p: p[:-1], "CorruptStreamError"),
    "segment trailing byte": (True, lambda p: p + b"\x00",
                              "BlockLengthError"),
}


CODEC_CORRUPTIONS = {   # name: (codec, payload -> payload, class name)
    "bwtdc shorter than header": ("bwtdc", lambda p: p[:10],
                                  "BlockLengthError"),
    "bwtdc dc_len past its cap": ("bwtdc", lambda p: p[:4] + struct.pack(
        "<I", 1028 + 5 * 4096 + 8 + 1) + p[8:], "CorruptStreamError"),
    "bwtdc index overruns payload": ("bwtdc", lambda p: p[:8] + struct.pack(
        "<I", len(p)) + p[12:], "BlockLengthError"),
    "bin shorter than its index length": ("bin", lambda p: p[:3],
                                          "CorruptStreamError"),
    "bin index overruns payload": ("bin", lambda p: struct.pack(
        "<I", len(p)) + p[4:], "CorruptStreamError"),
    # parse_chunk_index's ValueError escapes unwrapped in both packages
    "bin index truncated": ("apm", lambda p: struct.pack(
        "<I", int.from_bytes(p[:4], "little") - 1) + p[4:], "ValueError"),
    "bin stream byte": ("apm", lambda p: p[:-9] + bytes([p[-9] ^ 0x5A])
                        + p[-8:], "ChecksumError"),
}


@pytest.mark.parametrize("name", list(CODEC_CORRUPTIONS))
def test_codec_corruption_raises_same_class(name):
    """Corruptions that both packages reject with classes of one name."""
    codec, mutate, exp = CODEC_CORRUPTIONS[name]
    # one block: 4000 bytes for bwtdc, 500 for the bit coders (8 steps a
    # byte on the CPU)
    n = 4000 if codec == "bwtdc" else 500
    data = (b"she sells sea shells by the sea shore " * 120)[:n]
    blob = tpuzip_torch.compress(data, codec=codec, block_size=n + 96,
                                 device="cpu")
    assert _same_error(_with_payload(blob, mutate(blob[30:]))) == exp


@pytest.mark.parametrize("name", list(BWT_CORRUPTIONS))
def test_bwt_corruption_raises_same_class(monkeypatch, name):
    segmented, mutate, exp = BWT_CORRUPTIONS[name]
    if segmented:
        _segment_above(monkeypatch)
    data = (b"she sells sea shells by the sea shore " * 120)[:4000]
    blob = tpuzip_torch.compress(data, codec="bwt", block_size=4096,
                                 device="cpu")
    assert bool(blob[5] & 8) == segmented
    assert _same_error(_with_payload(blob, mutate(blob[30:]))) == exp


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


# the two packages raise classes of the same name from their own taxonomies
EXPECTED = {
    "magic": "HeaderError", "codec id": "HeaderError",
    "truncated header": "HeaderError",
    "truncated length table": "BlockLengthError",
    "trailing byte": "BlockLengthError", "short payload": "BlockLengthError",
    "index overruns payload": "BlockLengthError",
    "index truncated": "CorruptStreamError",
}


def _same_error(bad):
    """Decode `bad` with both packages; both must raise, with classes of
    one name.  Returns that name."""
    with pytest.raises(Exception) as mine:
        tpuzip_torch.decompress(bad, device="cpu")
    with pytest.raises(Exception) as ref:
        jrun.decompress(bad, mesh=MESH1)
    name = type(mine.value).__name__
    assert name == type(ref.value).__name__, (mine.value, ref.value)
    return name


@pytest.mark.parametrize("checksums", [False, True])
def test_corruption_raises_same_class(rng, checksums):
    data = (b"the quick brown fox jumps over the lazy dog " * 30)[:1000]
    blob = tpuzip_torch.compress(data, codec="ari", block_size=256,
                                 device="cpu", block_checksums=checksums)
    for name, bad in _mutations(blob, checksums).items():
        if name == "truncated checksum table" and not checksums:
            continue
        exp = EXPECTED.get(name, "BlockLengthError")
        if name == "stream byte":   # per-block sums name the block first
            exp = "CorruptStreamError" if checksums else "ChecksumError"
        assert _same_error(bad) == exp, name


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdevice.resolve("cuda")
    for codec in ("lz4", "rle", "ari", "bwt", "bwtdc", "bin", "apm",
                  "deflate"):
        with pytest.raises(RuntimeError):
            tpuzip_torch.compress(b"abc", codec=codec)
        blob = tpuzip_torch.compress(b"abc", codec=codec, block_size=256,
                                     device="cpu")
        with pytest.raises(RuntimeError):
            tpuzip_torch.decompress(blob, device="cuda")
    assert tdevice.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve("meta")


def test_unported_entry_points_name_the_roadmap():
    """open is ported (tests/test_torch_io.py): its default, an LZ4 frame,
    round-trips here and writes tpuzip's bytes; the part of item 15 still
    to port, ZlibWriter(batch_blocks=1), names its ROADMAP.md item.
    deflate and lz4p are ported (tests/test_torch_deflate.py,
    tests/test_torch_lz4p.py), and so are the corpus calls and
    compress_from_device, deflate's device rule included
    (tests/test_torch_serving.py, tests/test_torch_deflate_xla.py): their
    calls here give tpuzip's bytes."""
    native.available()   # tpuzip's writer takes its C++ coder, loaded first
    data = b"open me " * 100
    mine, theirs = io.BytesIO(), io.BytesIO()
    for mod, f in ((tpuzip_torch, mine), (tpuzip, theirs)):
        with mod.open(f, "wb", **({"device": "cpu"} if mod is tpuzip_torch
                                  else {})) as w:
            w.write(data)
    assert mine.getvalue() == theirs.getvalue()
    assert tpuzip_torch.open(io.BytesIO(mine.getvalue()),
                             device="cpu").read() == data
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 15"):
        tpuzip_torch.open(io.BytesIO(), "wb", format="zlib", batch_blocks=1,
                          device="cpu")
    zeros = np.zeros((1, 8), np.uint8)
    assert tpuzip_torch.compress_from_device(
        zeros, [8], codec="deflate", device="cpu") == \
        jrun.compress_from_device(zeros, [8], "deflate", mesh=MESH1)
    for codec in ("deflate", "lz4p"):
        assert tpuzip_torch.compress(b"x", codec=codec, device="cpu") == \
            jrun.compress(b"x", codec=codec, block_size=1 << 16, mesh=MESH1)
        assert tpuzip_torch.compress_corpus(b"x", codec=codec,
                                            device="cpu") \
            == jrun.compress_corpus(b"x", codec=codec, mesh=MESH1)
    deflate = jrun.compress(b"abc" * 100, codec="deflate", mesh=MESH1)
    assert tpuzip_torch.decompress(deflate, device="cpu") == b"abc" * 100
    lz4p = jrun.compress(b"abc" * 100, codec="lz4p", mesh=MESH1)
    assert tpuzip_torch.decompress(lz4p, device="cpu") == b"abc" * 100
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

