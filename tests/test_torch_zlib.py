"""The zlib wrapper (RFC 1950 over the deflate codec's device rule):
tpuzip_torch.codecs.zlib_ against tpuzip.codecs.zlib_ and Python's zlib,
on the CPU (the port's plain versions)."""

import struct
import zlib

import jax  # noqa: F401  (tests/conftest.py pins its platform)
import pytest
import torch

from tpuzip.codecs import zlib_ as jzlib
from tpuzip_torch.codecs import zlib_ as tzlib

with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [0, 1, 33, 5000])
def test_compress_byte_identical(n):
    """compress equals tpuzip's zlib_.compress, and Python's zlib and both
    packages' decompress read it back."""
    data = TEXT[:n]
    mine = tzlib.compress(data, device="cpu")
    assert mine == jzlib.compress(data)
    assert mine[:2] == b"\x78\x01"
    assert struct.unpack(">I", mine[-4:])[0] == zlib.adler32(data)
    assert zlib.decompress(mine) == data
    assert tzlib.decompress(mine, max(n, 1), device="cpu") == data
    assert jzlib.decompress(mine, max(n, 1)) == data


def test_compress_n_static():
    data = TEXT[:300]
    assert tzlib.compress(data, n_static=512, device="cpu") == \
        jzlib.compress(data, n_static=512)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_decompress_reads_zlib(level):
    """zlib.compress at levels 1, 6 and 9 (several block types), and a
    stored stream at level 0, read back."""
    data = TEXT[:6000] + bytes(300) + TEXT[:500]
    for lv in (level, 0):
        assert tzlib.decompress(zlib.compress(data, lv), len(data),
                                device="cpu") == data


def _bad_streams():
    good = bytearray(zlib.compress(TEXT[:2000], 6))
    adler = bytearray(good)
    adler[-1] ^= 1
    body = bytearray(good)
    body[len(body) // 2] ^= 0x10
    return {"short": b"\x78\x01\x03\x00", "method": b"\x79\x01" + bytes(8),
            "fcheck": b"\x78\x02" + bytes(8),
            "fdict": b"\x78\xbb" + bytes(8), "adler": bytes(adler),
            "body": bytes(body), "empty_body": b"\x78\x01" + bytes(4),
            "past_out_n": bytes(good)}


@pytest.mark.parametrize("name", sorted(_bad_streams()))
def test_bad_streams_raise_as_tpuzip(name):
    """A short stream, another method, a failed header check, a preset
    dictionary, a wrong Adler-32, a corrupt body, an empty body and output
    past out_n raise ValueError in both packages."""
    bad = _bad_streams()[name]
    out_n = 1999 if name == "past_out_n" else 2000
    for call in (lambda: jzlib.decompress(bad, out_n),
                 lambda: tzlib.decompress(bad, out_n, device="cpu")):
        with pytest.raises(ValueError):
            call()
