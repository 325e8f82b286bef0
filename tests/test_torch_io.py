"""tpuzip_torch.io's streaming adapters through tpuzip_torch.open, against
tpuzip's with its C++ coder loaded first (hazard (s): what tpuzip's
adapters write wherever tpuzip.runtime.native loads).  On the CPU the
port runs its plain versions: lz4_encode.cu's for the frame writer, the
deflate encoder's fragment mode for the zlib writer, the inflate with its
ends for the zlib reader, and the codecs' kernels for the framed codecs.
Also the two kernel modes the adapters add, against tpuzip's C++ and
oracle, and ROADMAP.md fault 9 (tpuzip's frame reader refuses block
checksums and misreads linked blocks; the port reads both)."""

import io
import struct
import zlib

import numpy as np
import pytest
import torch

from tpuzip.oracle import deflate as odeflate
from tpuzip.oracle import lz4 as olz4
from tpuzip.runtime import native
import tpuzip
import tpuzip_torch
from tpuzip_torch import io as tio
from tpuzip_torch.kernels import deflate_coder

with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    SURVEY = _f.read()
RNG = np.random.default_rng(77)
DATA = (SURVEY[:9000] + bytes(2000)
        + RNG.integers(0, 256, 1500, dtype=np.uint8).tobytes()
        + SURVEY[20000:23000])
# each format's writer knobs: blocks of at most 4 KiB, two a batch
KNOBS = {"lz4f": {"block_max": 1 << 16, "batch_blocks": 2},
         "zlib": {"block_size": 4096, "batch_blocks": 2},
         "ari": {"block_size": 4096, "batch_blocks": 2},
         "bwt": {"block_size": 4096, "batch_blocks": 2},
         "rle": {"block_size": 4096, "batch_blocks": 2},
         "mtf": {"block_size": 4096, "batch_blocks": 2},
         "dc": {"block_size": 2048, "batch_blocks": 2}}
CUTS = (0, 100, 5000, 5001, len(DATA))   # writes that split blocks


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the plain versions' small tensor ops wait on
    the other pytest-xdist workers' thread pools otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _native():
    """tpuzip's C++ coder, loaded before any of its adapters runs."""
    assert native.available()


def write(mod, fmt: str, data: bytes, cuts=CUTS, inner=None, **kw) -> bytes:
    f = inner or io.BytesIO()
    extra = {"device": "cpu"} if mod is tpuzip_torch else {}
    w = mod.open(f, "wb", format=fmt, **kw, **extra)
    for a, b in zip(cuts, cuts[1:]):
        w.write(data[a:b])
    w.close()
    return f.getvalue() if inner is None else None


def read(mod, fmt: str, blob: bytes, sizes=(7, 3000)) -> bytes:
    extra = {"device": "cpu"} if mod is tpuzip_torch else {}
    r = mod.open(io.BytesIO(blob), "rb", format=fmt, **extra)
    return b"".join(r.read(n) for n in sizes) + r.read()


@pytest.mark.parametrize("fmt", list(KNOBS))
def test_writer_and_reader_are_tpuzips(fmt):
    """Each writer writes tpuzip's bytes (writes that split blocks, a batch
    of two blocks and a short last batch); each reader returns from every
    read(n) what tpuzip's does, on the port's stream and on tpuzip's."""
    mine = write(tpuzip_torch, fmt, DATA, **KNOBS[fmt])
    assert mine == write(tpuzip, fmt, DATA, **KNOBS[fmt])
    assert read(tpuzip_torch, fmt, mine) == read(tpuzip, fmt, mine) == DATA
    r = tpuzip_torch.open(io.BytesIO(mine), "rb", format=fmt, device="cpu")
    t = tpuzip.open(io.BytesIO(mine), "rb", format=fmt)
    for n in (1, 4095, 4097, 0, 6000, -1, 5):
        assert r.read(n) == t.read(n)


def test_stream_codec_payloads_are_the_oracles():
    """The framed codecs' per-block payloads are tpuzip's oracles' streams
    (STREAM_CODECS of tpuzip/io.py), so the kernels' paths write them."""
    chunk = DATA[:4096]
    for fmt, (encode, _) in tpuzip.io.STREAM_CODECS.items():
        blob = write(tpuzip_torch, fmt, chunk, cuts=(0, len(chunk)),
                     block_size=4096)
        clen, olen = struct.unpack_from("<II", blob)
        assert olen == len(chunk)
        assert blob[8 : 8 + clen] == encode(chunk), fmt


@pytest.mark.parametrize("outer, inner", [("bwt", "ari"), ("mtf", "bwt")])
def test_chains_are_tpuzips(outer, inner):
    """bwt over ari and mtf over bwt over rle: the writers nest (the outer
    one writes into the inner one) and so do the readers."""
    chain = [outer, inner] + (["rle"] if outer == "mtf" else [])
    data = DATA[:6000]
    blobs = []
    for mod in (tpuzip_torch, tpuzip):
        extra = {"device": "cpu"} if mod is tpuzip_torch else {}
        f = io.BytesIO()
        ws = [f]
        for fmt in reversed(chain):
            ws.append(mod.open(ws[-1], "wb", format=fmt, block_size=2048,
                               **extra))
        ws[-1].write(data[:1000])
        ws[-1].write(data[1000:])
        for w in reversed(ws[1:]):
            w.close()
        blobs.append(f.getvalue())
    assert blobs[0] == blobs[1]
    r = io.BytesIO(blobs[0])
    for fmt in reversed(chain):
        r = tpuzip_torch.open(r, "rb", format=fmt, device="cpu")
    assert r.read() == data


def test_lz4_frame_nested_over_zlib():
    """Lz4FrameWriter writing into a ZlibWriter: tpuzip's bytes; the readers
    nested the same way read the data back, and stock zlib reads the
    outer stream."""
    data = DATA[:10000]
    blobs = []
    for mod in (tpuzip_torch, tpuzip):
        extra = {"device": "cpu"} if mod is tpuzip_torch else {}
        f = io.BytesIO()
        z = mod.open(f, "wb", format="zlib", block_size=4096, **extra)
        w = mod.open(z, "wb", format="lz4f", batch_blocks=2, **extra)
        w.write(data[:333])
        w.write(data[333:])
        w.close()
        z.close()
        blobs.append(f.getvalue())
    assert blobs[0] == blobs[1]
    assert olz4.decompress_frame(zlib.decompress(blobs[0])) == data
    r = tpuzip_torch.open(tpuzip_torch.open(io.BytesIO(blobs[0]), "rb",
                                            format="zlib", device="cpu"),
                          "rb", format="lz4f", device="cpu")
    assert r.read() == data


def test_zlib_reader_ignores_bytes_after_the_adler():
    """tpuzip's oracle reads the Adler-32 right after the stream's final
    block and ignores what follows; the port's reader too (the inflate's
    end), where codecs.zlib_.decompress takes the last 4 bytes."""
    for body in (zlib.compress(DATA, 6), write(tpuzip, "zlib", DATA)):
        blob = body + b"trailing bytes"
        assert read(tpuzip_torch, "zlib", blob) == \
            read(tpuzip, "zlib", blob) == DATA
    bad = bytearray(zlib.compress(DATA, 6))
    bad[-1] ^= 1
    for mod in (tpuzip_torch, tpuzip):
        with pytest.raises(ValueError, match="Adler-32"):
            read(mod, "zlib", bytes(bad) + b"more")


def test_zlib_reader_grows_its_output():
    """An output many times its stream (zeros): the inflate's output grows
    while its fault lies at the output's end; a corrupt stream still
    fails."""
    zeros = bytes(600_000)
    blob = zlib.compress(zeros, 9)
    assert read(tpuzip_torch, "zlib", blob) == zeros
    bad = bytearray(blob)
    bad[2] = 0xFF     # BTYPE 3
    for mod in (tpuzip_torch, tpuzip):
        with pytest.raises(ValueError):
            read(mod, "zlib", bytes(bad))


@pytest.mark.parametrize("mode", ["dynamic", "fixed", "stored"])
def test_fragments_are_tpzs(mode):
    """deflate_fragment_batch (the emit's fragment mode) writes
    tpz_deflate_fragment's bytes in each mode; the fragments splice into
    one stream that stock zlib reads."""
    chunks = [DATA[:4096], DATA[4096:8192], bytes(4096), DATA[-3000:],
              DATA[100:108], b"a"]
    rows = np.zeros((len(chunks), 4096), np.uint8)
    for k, c in enumerate(chunks):
        rows[k, : len(c)] = np.frombuffer(c, np.uint8)
    lens = np.array([len(c) for c in chunks], np.int32)
    comp, clens = native.deflate_fragment_batch(rows, lens, 64, mode=mode)
    got, glens = deflate_coder.deflate_fragment_batch(
        torch.from_numpy(rows), torch.from_numpy(lens), 64,
        {"dynamic": 0, "fixed": 1, "stored": 2}[mode])
    parts = [comp[k, : clens[k]].tobytes() for k in range(len(chunks))]
    assert [got[k, : glens[k]].numpy().tobytes()
            for k in range(len(chunks))] == parts
    d = zlib.decompressobj(-15)
    assert d.decompress(b"".join(parts) + b"\x03\x00") == b"".join(chunks)


def test_inflate_ends_are_the_oracles_consumed():
    """inflate_ends: where a stream decodes, the bytes its blocks took (the
    oracle's decompress_ex); where it fails, the bytes decoded before the
    fault."""
    streams = [zlib.compress(DATA, 6)[2:-4], odeflate.compress(DATA[:5000]),
               write(tpuzip, "zlib", DATA)[2:-4]]
    rows = np.zeros((len(streams) + 1, max(map(len, streams)) + 9), np.uint8)
    for k, st in enumerate(streams):
        rows[k, : len(st)] = np.frombuffer(st, np.uint8)
        rows[k, len(st) : len(st) + 9] = 0xAB   # bytes after the stream
    rows[-1, :1000] = rows[0, :1000]            # a stream cut short
    lens = torch.tensor([len(s) + 9 for s in streams] + [1000],
                        dtype=torch.int32)
    out, status, ends = deflate_coder.inflate_ends(
        torch.from_numpy(rows), lens, 1 << 15)
    for k, st in enumerate(streams):
        dec, used = odeflate.decompress_ex(st + bytes(9))
        assert int(status[k]) == len(dec) and int(ends[k]) == used
    assert int(status[-1]) == -1 and 0 < int(ends[-1]) < len(DATA)


def test_fault9_block_checksums_and_linked_frames_read():
    """ROADMAP.md fault 9, in tpuzip: its Lz4FrameReader never reads a
    block checksum (FLG bit 4), so it refuses a valid frame that has them,
    and it decodes linked blocks (FLG bit 5 clear) as independent ones.
    The port's reader reads both as tpuzip.oracle.lz4.decompress_frame
    does, in batches of blocks."""
    data = (SURVEY * 3)[:200_000]
    frame = olz4.compress_frame(data, block_max=1 << 16, block_checksum=True)
    assert olz4.decompress_frame(frame) == data
    with pytest.raises(ValueError, match="truncated frame"):
        tpuzip.open(io.BytesIO(frame)).read()
    r = tpuzip_torch.open(io.BytesIO(frame), device="cpu")
    assert r.read(5) + r.read() == data
    import chip_smoke

    linked = chip_smoke.linked_frame(data[:150_000], 1 << 16, False)
    assert olz4.decompress_frame(linked) == data[:150_000]
    with pytest.raises(Exception):
        assert tpuzip.open(io.BytesIO(linked)).read() == data[:150_000]
    reader = tio.Lz4FrameReader(io.BytesIO(linked), batch_blocks=1,
                                device="cpu")
    assert reader.read() == data[:150_000]


def test_reader_refusals():
    """A corrupt block, a wrong content checksum and a frame cut short
    raise ValueError; a block past block_max too, which tpuzip's reader
    does not check."""
    good = write(tpuzip_torch, "lz4f", DATA, **KNOBS["lz4f"])
    bad = bytearray(good)
    bad[-1] ^= 1
    for frame in (bytes(bad), good[:len(good) // 2], good[:5]):
        with pytest.raises(ValueError):
            read(tpuzip_torch, "lz4f", frame)
    bad = bytearray(good)
    struct.pack_into("<I", bad, 7, (1 << 16) + 1)
    with pytest.raises(ValueError, match="block length"):
        read(tpuzip_torch, "lz4f", bytes(bad))


def test_options_and_refusals():
    """ZlibWriter(batch_blocks=1), tpuzip's third rule, names its ROADMAP.md
    item; an unknown format or codec is refused; device="cuda" without a
    GPU raises; use_device is accepted and changes nothing."""
    with pytest.raises(NotImplementedError, match="item 15"):
        tio.ZlibWriter(io.BytesIO(), batch_blocks=1, device="cpu")
    with pytest.raises(ValueError):
        tpuzip_torch.open(io.BytesIO(), "wb", format="lz5", device="cpu")
    with pytest.raises(ValueError):
        tio.CodecWriter(io.BytesIO(), "lz4", device="cpu")
    with pytest.raises(RuntimeError):
        tpuzip_torch.open(io.BytesIO(), "wb")
    assert write(tpuzip_torch, "lz4f", DATA, use_device=False) == \
        write(tpuzip, "lz4f", DATA, use_device=False)
    assert tio.ADAPTER_BATCH == tpuzip.io.ADAPTER_BATCH
    assert set(tio.STREAM_CODECS) == set(tpuzip.io.STREAM_CODECS)


def test_mtf_codec_is_tpuzips():
    """codecs/mtf.py, which the mtf adapters run: each function's bytes are
    tpuzip.codecs.mtf's on a block and on a batch (valid prefixes; 0
    past each length in both)."""
    import jax.numpy as jnp

    from tpuzip.codecs import mtf as jmtf
    from tpuzip_torch.codecs import mtf as tmtf

    rows = np.frombuffer(DATA[:3 * 512], np.uint8).reshape(3, 512).copy()
    lens = np.array([512, 300, 0], np.int32)
    enc = tmtf.encode_batch(torch.from_numpy(rows), torch.from_numpy(lens))
    assert np.array_equal(enc.numpy(), np.asarray(jmtf.encode_batch(
        jnp.asarray(rows), jnp.asarray(lens))))
    dec = tmtf.decode_batch(enc, lens.tolist())
    assert np.array_equal(dec.numpy(), np.asarray(jmtf.decode_batch(
        jnp.asarray(enc.numpy()), jnp.asarray(lens))))
    one = tmtf.encode(torch.from_numpy(rows[1]), 300)
    assert np.array_equal(one.numpy(), np.asarray(jmtf.encode(
        jnp.asarray(rows[1]), 300)))
    assert np.array_equal(tmtf.decode(one, 300).numpy(), np.asarray(
        jmtf.decode(jnp.asarray(one.numpy()), 300)))
