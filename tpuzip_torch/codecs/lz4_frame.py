"""The LZ4 frame format on the device: the counterpart of
tpuzip/codecs/lz4_frame.py (frames that liblz4's frame API reads).

compress_frame writes tpuzip's bytes: its blocks from tpuzip's device lz4
encoder at hash_log 15 (kernels/lz4_dense.py; past 64 KiB blocks its
tiled links), each block stored where compression does not shrink it,
the 2-byte header check from the oracle on the host, and the content
checksum by csrc/xxh32.cu over the bytes uploaded for the encode.

decompress_frame reads what tpuzip's decompress_frame (its oracle's,
tpuzip/oracle/lz4.py:204-263) reads and refuses what it refuses, with
ValueError: independent blocks in one csrc/lz4_decode.cu launch, linked
blocks one launch a block in its history mode (up to 64 KiB of the output
before it), block checksums in one batched xxh32 launch over the payloads
as written, and the content checksum over the output on the device
before its download.  Where the oracle raises IndexError or struct.error
on a frame cut short, this raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from tpuzip_torch.core import blocks as blk
from tpuzip_torch.device import resolve
from tpuzip_torch.oracle.lz4 import MAGIC, _BD_MAX_SIZES
from tpuzip_torch.oracle.xxh32 import xxh32

HASH_LOG = 15      # tpuzip's compress_frame encodes at its XLA default
WINDOW = 1 << 16   # a linked block's matches reach this far back


def header(block_max: int, content_checksum: bool) -> bytes:
    """The magic, FLG (version 1, independent blocks, the content checksum
    flag), BD and the header check byte, as tpuzip writes them; KeyError
    for a block_max that is no BD size, as in tpuzip."""
    bd_id = {v: k for k, v in _BD_MAX_SIZES.items()}[block_max]
    flg = (1 << 6) | (1 << 5) | (int(content_checksum) << 2)
    descriptor = bytes([flg, bd_id << 4])
    return (struct.pack("<I", MAGIC) + descriptor
            + bytes([(xxh32(descriptor) >> 8) & 0xFF]))


def content_hash(flat: torch.Tensor) -> int:
    """xxh32 of a 1-D u8 tensor, on its device."""
    from tpuzip_torch.kernels import xxh32 as kx

    rows = flat.reshape(1, -1)
    n = torch.tensor([flat.numel()], dtype=torch.int32, device=flat.device)
    return int(kx.xxh32_batch(rows, n)[0])


def write_blocks(out: bytearray, chunks, comp: np.ndarray,
                 clens: np.ndarray) -> None:
    """Each block's frame record onto out: [len u32][stream], or, where the
    stream does not shrink the block, [len | 2^31][raw bytes]; an empty
    block writes nothing (tpuzip's rule, compress_frame and
    Lz4FrameWriter alike).  comp holds the streams end to end."""
    at = 0
    for chunk, c in zip(chunks, clens.tolist()):
        if len(chunk) and c < len(chunk):
            out += struct.pack("<I", c) + comp[at : at + c].tobytes()
        elif len(chunk):
            out += struct.pack("<I", len(chunk) | 0x80000000) + bytes(chunk)
        at += c


def compact(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Each row's first lens bytes, end to end (1-D, on the rows' device)."""
    keep = (torch.arange(rows.shape[1], device=rows.device)[None, :]
            < lens.to(torch.int64)[:, None])
    return rows[keep]


def compress_frame(data: bytes, block_max: int = 1 << 16,
                   content_checksum: bool = True, device="cuda") -> bytes:
    """data as an LZ4 frame of independent blocks of block_max bytes (64,
    256 KiB, 1 or 4 MiB): tpuzip's compress_frame, byte for byte."""
    from tpuzip_torch.dist.runner import _compact
    from tpuzip_torch.kernels import lz4_dense

    out = bytearray(header(block_max, content_checksum))
    dev = resolve(device)
    blocks_np, lens_np = blk.chunk(data, block_max)
    blocks = torch.from_numpy(blocks_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    comp, clens = lz4_dense.lz4_dense_encode_batch(blocks, lens, HASH_LOG)
    digest = (content_hash(blocks.reshape(-1)[: len(data)])
              if content_checksum else None)
    clens_np, payload = _compact(comp, clens)
    mv = memoryview(data)
    chunks = [mv[k : k + block_max] for k in range(0, len(data), block_max)]
    write_blocks(out, chunks, np.frombuffer(payload, np.uint8), clens_np)
    out += struct.pack("<I", 0)
    if content_checksum:
        out += struct.pack("<I", digest)
    return bytes(out)


class Descriptor:
    """A frame's header fields (FLG, BD), read as tpuzip's decompress_frame
    reads them: version 1 or ValueError, a BD size id of 4-7 or
    ValueError; the content size and the dictionary id skipped, the
    header check byte tolerated."""

    def __init__(self, flg: int, bd: int) -> None:
        if flg >> 6 != 1:
            raise ValueError("unsupported LZ4 frame version")
        self.independent = bool((flg >> 5) & 1)
        self.block_checksum = bool((flg >> 4) & 1)
        self.content_checksum = bool((flg >> 2) & 1)
        # the content size, the dictionary id and the check byte
        self.skip = 8 * ((flg >> 3) & 1) + 4 * (flg & 1) + 1
        bd_id = (bd >> 4) & 7
        if bd_id not in _BD_MAX_SIZES:
            raise ValueError("bad BD byte")
        self.block_max = _BD_MAX_SIZES[bd_id]


class Blocks:
    """Blocks of one frame read on the device: their payloads as written
    (upload), their block checksums (check_blocks), their decode
    (decode: every block of an independent frame in one launch; a linked
    frame's one launch a block after the window of its output so far)."""

    def __init__(self, desc: Descriptor, dev: torch.device) -> None:
        self.desc, self.dev = desc, dev
        self.window = torch.zeros(0, dtype=torch.uint8, device=dev)

    def decode(self, payloads, stored, sums) -> torch.Tensor:
        """The output of the blocks (payloads as bytes, stored flags, their
        block checksums or None), 1-D on the device."""
        if not payloads:
            return torch.zeros(0, dtype=torch.uint8, device=self.dev)
        rows, plens = upload(payloads, self.dev)
        if self.desc.block_checksum:
            check_blocks(rows, plens, sums)
        if not self.desc.independent:
            return torch.cat([self._linked(rows[k, : len(p)], p, s)
                              for k, (p, s) in enumerate(zip(payloads,
                                                              stored))])
        return self._independent(rows, plens, stored)

    def _independent(self, rows, plens, stored) -> torch.Tensor:
        from tpuzip_torch.kernels import lz4_coder

        bm = self.desc.block_max
        st = torch.tensor(stored, device=self.dev)
        idx = torch.nonzero(~st).flatten()
        olens = plens.to(torch.int64)
        full = torch.zeros((rows.shape[0], bm), dtype=torch.uint8,
                           device=self.dev)
        w = min(rows.shape[1], bm)
        full[:, :w] = torch.where(st[:, None], rows[:, :w], 0)
        if idx.numel():
            dec, status = lz4_coder.lz4_decode_batch(
                rows[idx].contiguous(), plens[idx].contiguous(), bm)
            if bool((status < 0).any()):
                raise ValueError("corrupt LZ4 block")
            full[idx] = dec
            olens[idx] = status
        return compact(full, olens)

    def _linked(self, row: torch.Tensor, payload: bytes,
                stored: bool) -> torch.Tensor:
        from tpuzip_torch.kernels import lz4_coder

        if stored:
            dec = row
        else:
            out, status = lz4_coder.lz4_decode_batch(
                row[None].contiguous(),
                torch.tensor([len(payload)], dtype=torch.int32,
                             device=self.dev),
                self.desc.block_max, history=self.window[None].contiguous())
            got = int(status[0])
            if got < 0:
                raise ValueError("corrupt linked LZ4 block")
            dec = out[0, :got]
        self.window = torch.cat([self.window, dec])[-WINDOW:]
        return dec


def upload(payloads, dev):
    """(rows (B, longest) u8 on dev, lengths (B,) i32) of byte strings."""
    width = max(max((len(p) for p in payloads), default=0), 1)
    rows = np.zeros((len(payloads), width), np.uint8)
    for k, p in enumerate(payloads):
        rows[k, : len(p)] = np.frombuffer(p, np.uint8)
    lens = np.array([len(p) for p in payloads], np.int32)
    return (torch.from_numpy(rows).to(dev),
            torch.from_numpy(lens).to(dev))


def check_blocks(rows: torch.Tensor, plens: torch.Tensor, sums) -> None:
    """Each payload's xxh32 (one batched launch) against its block
    checksum; ValueError on the first that differs."""
    from tpuzip_torch.kernels import xxh32 as kx

    got = kx.xxh32_batch(rows, plens).cpu().tolist()
    if got != list(sums):
        raise ValueError("LZ4 block checksum mismatch")


def _u32(data: bytes, at: int) -> int:
    if at + 4 > len(data):
        raise ValueError("truncated LZ4 frame")
    return struct.unpack_from("<I", data, at)[0]


def decompress_frame(data: bytes, device="cuda") -> bytes:
    """An LZ4 frame's content, as tpuzip's decompress_frame reads it."""
    dev = resolve(device)
    if _u32(data, 0) != MAGIC:
        raise ValueError(f"bad LZ4 frame magic: {_u32(data, 0):#x}")
    if len(data) < 6:
        raise ValueError("truncated LZ4 frame")
    desc = Descriptor(data[4], data[5])
    i = 6 + desc.skip
    payloads, stored, sums = [], [], []
    while True:
        blen = _u32(data, i)
        i += 4
        if blen == 0:
            break
        stored.append(bool(blen & 0x80000000))
        blen &= 0x7FFFFFFF
        if blen > desc.block_max:
            raise ValueError("block length exceeds frame maximum")
        if i + blen > len(data):
            raise ValueError("truncated LZ4 frame")
        payloads.append(data[i : i + blen])
        i += blen
        if desc.block_checksum:
            sums.append(_u32(data, i))
            i += 4
    out = Blocks(desc, dev).decode(payloads, stored, sums)
    if desc.content_checksum and _u32(data, i) != content_hash(out):
        raise ValueError("LZ4 content checksum mismatch")
    return out.cpu().numpy().tobytes()


__all__ = ["compress_frame", "decompress_frame"]
