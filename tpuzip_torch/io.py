"""Streaming file-like adapters over the port's kernels: the counterpart
of tpuzip/io.py, under its names and signatures, plus ``device=``.

Writers buffer their input and push whole batches of blocks through the
kernels; readers pull and decode a batch at a time.  They nest like
tpuzip's (``Lz4FrameWriter(ZlibWriter(f))``).  Formats and bytes are
tpuzip's with its C++ coder loaded (what its adapters write wherever
``tpuzip.runtime.native`` loads):

  Lz4FrameWriter  an LZ4 frame of independent blocks, each from
                  csrc/lz4_encode.cu at hash_log 16 (tpuzip's
                  native.lz4_compress_batch), stored where it does not
                  shrink; the content checksum streamed through
                  core.checksum.Xxh32Stream on the uploaded batches.
                  use_device is accepted and has no effect, as in tpuzip
                  with its C++ coder loaded.
  Lz4FrameReader  what codecs.lz4_frame.decompress_frame reads, a batch of
                  up to batch_blocks blocks a launch: block checksums and
                  linked blocks included (tpuzip's reader refuses the
                  first and misreads the second: ROADMAP.md fault 9).  It
                  reads a batch ahead, so a corrupt later block of a batch
                  raises before the batch's earlier bytes are returned.
  ZlibWriter      a 2-byte header, the batches as deflate fragments of
                  tpuzip's C++ rule at max_chain 64 (csrc/deflate_encode.cu's
                  fragment mode: no BFINAL, each ending byte-aligned after
                  an empty stored block), a final empty stored block and
                  the Adler-32, big-endian.  batch_blocks=1 (tpuzip's third
                  rule, the oracle's lazy parse with bit state carried from
                  block to block) is not ported.
  ZlibReader      tpuzip's oracle's reading through csrc/inflate.cu: the
                  Adler-32 right after the stream's final block, bytes
                  after it ignored; the output grown while the inflate
                  faults at its end.
  CodecWriter/CodecReader  [comp_len u32][orig_len u32][payload] a block,
                  comp_len 0 at the end; the payloads of ari, bwt, rle,
                  mtf and dc are tpuzip's oracles' streams (STREAM_CODECS),
                  from csrc/ari_encode.cu and ari_decode.cu's no-index
                  mode, the port's BWT, csrc/rle.cu, csrc/mtf.cu,
                  codecs/dc.py and csrc/dc_decode.cu.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from tpuzip_torch.codecs import lz4_frame
from tpuzip_torch.core.checksum import AdlerStream, Xxh32Stream
from tpuzip_torch.device import resolve

__all__ = ["Lz4FrameWriter", "Lz4FrameReader", "ZlibWriter", "ZlibReader",
           "CodecWriter", "CodecReader", "STREAM_CODECS", "ADAPTER_BATCH"]

# blocks a writer buffers, and a reader decodes, at a time (tpuzip's)
ADAPTER_BATCH = 64
LZ4_HASH_LOG = 16      # tpuzip's native.lz4_compress_batch
ZLIB_MAX_CHAIN = 64    # tpuzip's native.deflate_fragment_batch
INFLATE_SLACK = 1 << 16   # a fault this near the output's end may be it


def _chunks(buf, size: int, end: int) -> list:
    return [bytes(buf[k : min(k + size, end)]) for k in range(0, end, size)]


def _rows(chunks, width: int, dev):
    """(rows (B, width) u8 on dev, zero past each chunk; lengths (B,) i32;
    the chunks end to end, 1-D on dev, a view of the rows where every
    chunk but the last fills its row)."""
    flat_np = np.frombuffer(b"".join(chunks), np.uint8)
    total = flat_np.size
    rows = torch.zeros((len(chunks), width), dtype=torch.uint8, device=dev)
    lens = torch.tensor([len(c) for c in chunks], dtype=torch.int32,
                        device=dev)
    if all(len(c) == width for c in chunks[:-1]):
        flat = rows.reshape(-1)
        flat[:total] = torch.from_numpy(flat_np.copy()).to(dev)
        return rows, lens, flat[:total]
    for k, c in enumerate(chunks):
        rows[k, : len(c)] = torch.from_numpy(
            np.frombuffer(c, np.uint8).copy()).to(dev)
    return rows, lens, lz4_frame.compact(rows, lens)


def _compact(comp: torch.Tensor, clens: torch.Tensor):
    """(clens on the host, each row's first clens bytes end to end)."""
    from tpuzip_torch.dist import runner

    return runner._compact(comp, clens)


def _download(comp: torch.Tensor, clens: torch.Tensor) -> list:
    """Each row's first clens bytes, as bytes."""
    clens_np, payload = _compact(comp, clens)
    ends = np.cumsum(clens_np)
    return [payload[e - c : e] for e, c in zip(ends.tolist(),
                                               clens_np.tolist())]


class _WriterBase:
    def __init__(self, inner, device):
        self.inner = inner
        self.closed = False
        self.dev = resolve(device)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def writable(self) -> bool:
        return True


class _ReaderBase:
    """read(n) over `pending`, filled a batch at a time by _pull, as
    tpuzip's readers serve it."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        while not self.done and (n < 0 or len(self.pending) < n):
            self._pull()
        if n < 0:
            out = bytes(self.pending)
            self.pending.clear()
        else:
            out = bytes(self.pending[:n])
            del self.pending[:n]
        return out


class Lz4FrameWriter(_WriterBase):
    """Incremental LZ4 frame writer: batches of batch_blocks blocks of
    block_max bytes through csrc/lz4_encode.cu (tpuzip's C++ rule)."""

    def __init__(self, inner, block_max: int = 1 << 16,
                 content_checksum: bool = True, use_device: bool = True,
                 batch_blocks: int | None = None, device="cuda"):
        super().__init__(inner, device)
        self.block_max = block_max
        self.content_checksum = content_checksum
        self.use_device = use_device
        self.batch_blocks = (ADAPTER_BATCH if batch_blocks is None
                             else max(1, batch_blocks))
        self.buf = bytearray()
        self.xxh = Xxh32Stream(device=self.dev)
        inner.write(lz4_frame.header(block_max, content_checksum))

    def write(self, data: bytes) -> int:
        self.buf += data
        hi = self.batch_blocks * self.block_max
        while len(self.buf) >= hi:
            self._emit_batch(_chunks(self.buf, self.block_max, hi))
            del self.buf[:hi]
        return len(data)

    def _emit_batch(self, chunks) -> None:
        from tpuzip_torch.kernels import lz4_coder

        rows, lens, flat = _rows(chunks, self.block_max, self.dev)
        comp, clens = lz4_coder.lz4_encode_batch(rows, lens, LZ4_HASH_LOG)
        if self.content_checksum:
            self.xxh.update(flat)
        clens_np, payload = _compact(comp, clens)
        out = bytearray()
        lz4_frame.write_blocks(out, chunks, np.frombuffer(payload, np.uint8),
                               clens_np)
        self.inner.write(bytes(out))

    def close(self) -> None:
        if self.closed:
            return
        if self.buf:
            self._emit_batch(_chunks(self.buf, self.block_max, len(self.buf)))
            self.buf.clear()
        self.inner.write(struct.pack("<I", 0))
        if self.content_checksum:
            self.inner.write(struct.pack("<I", self.xxh.digest()))
        self.closed = True


class Lz4FrameReader(_ReaderBase):
    """Incremental LZ4 frame reader, up to batch_blocks blocks a decode."""

    def __init__(self, inner, batch_blocks: int = ADAPTER_BATCH,
                 device="cuda"):
        self.inner = inner
        self.dev = resolve(device)
        self.batch_blocks = max(1, batch_blocks)
        hdr = inner.read(6)
        if len(hdr) < 6:
            raise ValueError("truncated frame")
        if struct.unpack_from("<I", hdr, 0)[0] != lz4_frame.MAGIC:
            raise ValueError("bad LZ4 frame magic")
        self.desc = lz4_frame.Descriptor(hdr[4], hdr[5])
        if len(inner.read(self.desc.skip)) < self.desc.skip:
            raise ValueError("truncated frame")
        self.blocks = lz4_frame.Blocks(self.desc, self.dev)
        self.pending = bytearray()
        self.done = False
        self.xxh = Xxh32Stream(device=self.dev)

    def _u32(self) -> int:
        raw = self.inner.read(4)
        if len(raw) < 4:
            raise ValueError("truncated frame")
        return struct.unpack("<I", raw)[0]

    def _pull(self) -> None:
        payloads, stored, sums = [], [], []
        end = False
        while len(payloads) < self.batch_blocks:
            blen = self._u32()
            if blen == 0:
                end = True
                break
            stored.append(bool(blen & 0x80000000))
            blen &= 0x7FFFFFFF
            if blen > self.desc.block_max:
                raise ValueError("block length exceeds frame maximum")
            payload = self.inner.read(blen)
            if len(payload) < blen:
                raise ValueError("truncated frame")
            payloads.append(payload)
            if self.desc.block_checksum:
                sums.append(self._u32())
        dec = self.blocks.decode(payloads, stored, sums)
        if self.desc.content_checksum:
            self.xxh.update(dec)
        self.pending += dec.cpu().numpy().tobytes()
        if end:
            if (self.desc.content_checksum
                    and self._u32() != self.xxh.digest()):
                raise ValueError("LZ4 content checksum mismatch")
            self.done = True


class ZlibWriter(_WriterBase):
    """Streaming zlib: the batches as byte-aligned non-final deflate
    fragments (tpuzip's native.deflate_fragment_batch), a final empty
    stored block, the Adler-32."""

    def __init__(self, inner, block_size: int = 1 << 16,
                 batch_blocks: int | None = None, device="cuda"):
        from tpuzip_torch.dist.runner import not_ported

        self.batch_blocks = (ADAPTER_BATCH if batch_blocks is None
                             else max(1, batch_blocks))
        if self.batch_blocks == 1:
            raise not_ported("ZlibWriter(batch_blocks=1), tpuzip's lazy "
                             "parse of its oracle with its bit state carried "
                             "from block to block,", 15)
        super().__init__(inner, device)
        self.block_size = block_size
        self.buf = bytearray()
        self.adler = AdlerStream()
        cmf, flg = 0x78, 0
        rem = (cmf * 256 + flg) % 31
        if rem:
            flg += 31 - rem
        inner.write(bytes([cmf, flg]))

    def write(self, data: bytes) -> int:
        self.buf += data
        self.adler.feed(bytes(data))
        hi = self.batch_blocks * self.block_size
        while len(self.buf) >= hi:
            self._emit_batch(_chunks(self.buf, self.block_size, hi))
            del self.buf[:hi]
        return len(data)

    def _emit_batch(self, chunks) -> None:
        from tpuzip_torch.kernels import deflate_coder

        rows, lens, _ = _rows(chunks, self.block_size, self.dev)
        comp, clens = deflate_coder.deflate_fragment_batch(
            rows, lens, ZLIB_MAX_CHAIN)
        if bool((clens < 0).any()):
            raise ValueError("deflate_fragment_batch failed")
        self.inner.write(b"".join(_download(comp, clens)))

    def close(self) -> None:
        if self.closed:
            return
        if self.buf:
            self._emit_batch(_chunks(self.buf, self.block_size,
                                     len(self.buf)))
            self.buf.clear()
        # the final empty stored block: BFINAL, BTYPE 00, the byte
        # boundary, LEN 0 and NLEN 0xFFFF (every fragment ends aligned)
        self.inner.write(b"\x01\x00\x00\xff\xff")
        self.inner.write(struct.pack(">I", self.adler.result()))
        self.closed = True


class ZlibReader(_ReaderBase):
    """zlib reader (buffers the inner stream; serves it incrementally)."""

    def __init__(self, inner, device="cuda"):
        self.data = inner.read()
        self.dev = resolve(device)
        self.pos = 0
        self._out: bytes | None = None

    def _decompress(self) -> bytes:
        from tpuzip_torch.kernels import deflate_coder

        data = self.data
        if len(data) < 6:
            raise ValueError("zlib stream too short")
        cmf, flg = data[0], data[1]
        if cmf & 0x0F != 8:
            raise ValueError("unsupported compression method (CM != 8)")
        if (cmf * 256 + flg) % 31 != 0:
            raise ValueError("zlib header FCHECK failed")
        if flg & 0x20:
            raise ValueError("FDICT preset dictionaries unsupported")
        body = np.frombuffer(data, np.uint8)[2:]
        rows = torch.from_numpy(body.copy()).to(self.dev)[None]
        lens = torch.tensor([body.size], dtype=torch.int32, device=self.dev)
        cap = max(4 * body.size, INFLATE_SLACK)
        while True:
            out, status, ends = deflate_coder.inflate_ends(rows, lens, cap)
            got, end = int(status[0]), int(ends[0])
            if got >= 0:
                break
            # a fault within INFLATE_SLACK of the output's end may be the
            # output's end: decode again into twice the room
            if end + INFLATE_SLACK <= cap or 2 * cap >= 1 << 31:
                raise ValueError("corrupt DEFLATE stream")
            cap *= 2
        tail = data[2 + end : 2 + end + 4]
        if len(tail) < 4:
            raise ValueError("truncated zlib stream (missing Adler-32)")
        result = out[0, :got].cpu().numpy().tobytes()
        adler = AdlerStream()
        adler.feed(result)
        (expect,) = struct.unpack(">I", tail)
        if expect != adler.result():
            raise ValueError(f"Adler-32 mismatch: {expect:#x} != "
                             f"{adler.result():#x}")
        return result

    def read(self, n: int = -1) -> bytes:
        if self._out is None:
            self._out = self._decompress()
        if n < 0:
            out, self._out = self._out[self.pos:], b""
            self.pos = 0
            return out
        out = self._out[self.pos : self.pos + n]
        self.pos += n
        return out


# ---------------------------------------------------------------------------
# Framed block-codec adapters: per block [comp_len u32 LE][orig_len u32
# LE][payload], comp_len 0 at the end.  Payloads are tpuzip's oracles'
# streams: ari = oracle.ari.encode_bytes, bwt = origin u32 LE + the last
# column, rle / mtf / dc = the oracles' streams.
# ---------------------------------------------------------------------------


def _out_width(olens) -> int:
    """The decoders' row width for a batch: tpuzip's (the longest block
    rounded up to a power of two, at least 256), so that a stream that
    decodes past it fails where tpuzip's fails."""
    n = max(max(olens), 1)
    return max(1 << (n - 1).bit_length() if n > 1 else 1, 256)


def _ari_enc(rows, lens):
    from tpuzip_torch.kernels import range_coder

    streams, slens, _ = range_coder.ari_encode_indexed(rows, lens)
    return _download(streams, slens)


def _ari_dec(payloads, olens, dev):
    from tpuzip_torch.kernels import range_decoder

    rows, _ = lz4_frame.upload([p + b"\x00" for p in payloads], dev)
    lens = torch.tensor(olens, dtype=torch.int32, device=dev)
    out = range_decoder.decode_batch(rows, lens, _out_width(olens))
    return [out[k, :n] for k, n in enumerate(olens)]


def _bwt_enc(rows, lens):
    from tpuzip_torch.codecs import bwt

    L, origins = bwt.encode_batch(rows, lens)
    return [struct.pack("<I", o) + c for o, c in
            zip(origins.cpu().tolist(), _download(L, lens))]


def _bwt_dec(payloads, olens, dev):
    from tpuzip_torch.codecs import bwt

    if any(len(p) < 4 for p in payloads):
        raise ValueError("bwt payload shorter than its origin")
    origins = torch.tensor([struct.unpack_from("<I", p)[0] for p in payloads],
                           dtype=torch.int64, device=dev)
    rows, lens = lz4_frame.upload([p[4:] for p in payloads], dev)
    out = bwt.decode_batch(rows, origins, lens)
    return [out[k, : len(p) - 4] for k, p in enumerate(payloads)]


def _rle_enc(rows, lens):
    from tpuzip_torch.kernels import rle_coder

    return _download(*rle_coder.rle_encode_batch(rows, lens))


def _rle_dec(payloads, olens, dev):
    from tpuzip_torch.kernels import rle_coder

    rows, lens = lz4_frame.upload(payloads, dev)
    out, status = rle_coder.rle_decode_batch(rows, lens, _out_width(olens))
    st = status.cpu().tolist()
    if min(st) < 0:
        raise ValueError("rle stream corrupt in adapter batch")
    return [out[k, :n] for k, n in enumerate(st)]


def _mtf_enc(rows, lens):
    from tpuzip_torch.codecs import mtf

    return _download(mtf.encode_batch(rows, lens), lens)


def _mtf_dec(payloads, olens, dev):
    from tpuzip_torch.codecs import mtf

    rows, lens = lz4_frame.upload(payloads, dev)
    out = mtf.decode_batch(rows, lens)
    return [out[k, : len(p)] for k, p in enumerate(payloads)]


def _dc_enc(rows, lens):
    from tpuzip_torch.codecs import dc

    return _download(*dc.encode_batch(rows, lens))


def _dc_dec(payloads, olens, dev):
    from tpuzip_torch.codecs import dc

    rows, lens = lz4_frame.upload(payloads, dev)
    out, length, err = dc.decode_batch(rows, lens, _out_width(olens))
    if bool(err.any()):
        raise ValueError("dc stream corrupt in adapter batch")
    return [out[k, :n] for k, n in enumerate(length.cpu().tolist())]


# codec: (encode (rows, lengths) -> payloads, decode (payloads, orig
# lengths, device) -> each block's bytes as a device tensor)
STREAM_CODECS = {
    "ari": (_ari_enc, _ari_dec),
    "bwt": (_bwt_enc, _bwt_dec),
    "rle": (_rle_enc, _rle_dec),
    "mtf": (_mtf_enc, _mtf_dec),
    "dc": (_dc_enc, _dc_dec),
}


class CodecWriter(_WriterBase):
    """Framed streaming encoder for any block codec of STREAM_CODECS, a
    batch of batch_blocks blocks a launch."""

    def __init__(self, inner, codec: str, block_size: int = 1 << 16,
                 batch_blocks: int = ADAPTER_BATCH, device="cuda"):
        if codec not in STREAM_CODECS:
            raise ValueError(f"unknown streaming codec {codec!r}")
        super().__init__(inner, device)
        self.codec = codec
        self.block_size = block_size
        self.batch_blocks = max(1, batch_blocks)
        self.buf = bytearray()

    def write(self, data: bytes) -> int:
        self.buf += data
        hi = self.batch_blocks * self.block_size
        while len(self.buf) >= hi:
            self._emit_batch(_chunks(self.buf, self.block_size, hi))
            del self.buf[:hi]
        return len(data)

    def _emit_batch(self, chunks) -> None:
        rows, lens, _ = _rows(chunks, max(len(c) for c in chunks), self.dev)
        payloads = STREAM_CODECS[self.codec][0](rows, lens)
        for chunk, payload in zip(chunks, payloads):
            self.inner.write(struct.pack("<II", len(payload), len(chunk)))
            self.inner.write(payload)

    def flush(self) -> None:
        if self.buf:
            self._emit_batch(_chunks(self.buf, self.block_size,
                                     len(self.buf)))
            self.buf.clear()

    def close(self) -> None:
        if self.closed:
            return
        self.flush()
        # the end mark only; the inner stream stays open
        self.inner.write(struct.pack("<I", 0))
        self.closed = True


class CodecReader(_ReaderBase):
    """Framed streaming decoder, up to batch_blocks frames a launch."""

    def __init__(self, inner, codec: str,
                 batch_blocks: int = ADAPTER_BATCH, device="cuda"):
        if codec not in STREAM_CODECS:
            raise ValueError(f"unknown streaming codec {codec!r}")
        self.inner = inner
        self.codec = codec
        self.dev = resolve(device)
        self.batch_blocks = max(1, batch_blocks)
        self.pending = bytearray()
        self.done = False

    def _read_frame(self):
        """One frame (payload, olen) or None at the end mark."""
        hdr = self.inner.read(4)
        if len(hdr) < 4:
            raise ValueError("truncated codec stream")
        (clen,) = struct.unpack("<I", hdr)
        if clen == 0:
            self.done = True
            return None
        hdr2 = self.inner.read(4)
        if len(hdr2) < 4:
            raise ValueError("truncated codec stream header")
        (olen,) = struct.unpack("<I", hdr2)
        payload = self.inner.read(clen)
        if len(payload) < clen:
            raise ValueError("truncated codec stream payload")
        return payload, olen

    def _pull(self) -> None:
        payloads, olens = [], []
        while len(payloads) < self.batch_blocks:
            frame = self._read_frame()
            if frame is None:
                break
            payloads.append(frame[0])
            olens.append(frame[1])
        if not payloads:
            return
        outs = STREAM_CODECS[self.codec][1](payloads, olens, self.dev)
        for out, olen in zip(outs, olens):
            if out.numel() != olen:
                raise ValueError(
                    f"{self.codec} block decoded to {out.numel()} bytes, "
                    f"header says {olen}")
        self.pending += torch.cat(outs).cpu().numpy().tobytes()
