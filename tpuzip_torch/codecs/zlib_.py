"""The zlib container (RFC 1950) over the deflate codec's device rule
(tpuzip/codecs/zlib_.py, which tpuzip's CLI ``-f zlib`` writes): a 2-byte
header, one raw stream of codecs.deflate.deflate, and the data's Adler-32,
big-endian.  The Adler-32 is the container path's own host one
(dist.runner.corpus_adler32).
"""

from __future__ import annotations

import struct

from tpuzip_torch.codecs import deflate as cdeflate


def _adler32(data: bytes) -> int:
    from tpuzip_torch.dist.runner import corpus_adler32

    return corpus_adler32(data)


def compress(data: bytes, n_static: int | None = None,
             device="cuda") -> bytes:
    """data as a zlib stream: CMF 0x78 (deflate, 32 KiB window), FLG with
    its check bits, the stream of deflate(data, n_static), the Adler-32."""
    cmf, flg = 0x78, 0
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    body = cdeflate.deflate(data, n_static=n_static, device=device)
    return bytes([cmf, flg]) + body + struct.pack(">I", _adler32(data))


def decompress(data: bytes, out_n: int, device="cuda") -> bytes:
    """A zlib stream's data, at most out_n bytes; ValueError, as tpuzip
    raises it, on a stream under 6 bytes, a method other than deflate, a
    failed header check, a preset dictionary, a corrupt stream or an
    Adler-32 that differs."""
    if len(data) < 6:
        raise ValueError("zlib stream too short")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != 8:
        raise ValueError("unsupported compression method (CM != 8)")
    if (cmf * 256 + flg) % 31 != 0:
        raise ValueError("zlib header FCHECK failed")
    if flg & 0x20:
        raise ValueError("FDICT preset dictionaries unsupported")
    out = cdeflate.inflate(data[2:-4], out_n, device=device)
    (expect,) = struct.unpack(">I", data[-4:])
    actual = _adler32(out)
    if expect != actual:
        raise ValueError(f"Adler-32 mismatch: {expect:#x} != {actual:#x}")
    return out
