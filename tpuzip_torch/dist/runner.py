"""The tpz container, ari codec: compress and decompress on one device.

Port of the ari parts of tpuzip/dist/runner.py, byte for byte the same
container:

  magic 'TPZ1' | codec u8 | flags u8 | block_size u32 LE | num_blocks u32 LE
  | orig_len u64 LE | adler32(orig) u32 LE | comp_lens u32[num_blocks] LE
  | [flags&1: block_adler u32[num_blocks] LE]
  | [flags&4: <HI> (increment, threshold) when not (8, 8192)]
  | payloads, per block [u32 idx_len][chunk index][ari stream]  (flags&2)

The corpus is cut into blocks (tpuzip.core.blocks), the blocks go to the
device as one (B, block_size) batch, and the chunk-indexed range coder
kernels encode or decode the whole batch in one launch.  The port runs on
one device, so unlike tpuzip it never pads the batch to a mesh width; it
decodes tpuzip's padded containers all the same.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from tpuzip.core import blocks as blk
from tpuzip.core.config import Config
from tpuzip.runtime.errors import (BlockLengthError, ChecksumError,
                                   CorruptStreamError, HeaderError)
from tpuzip_torch.codecs.ari import check_knobs, encode_cap
from tpuzip_torch.core.checksum import adler32_batch
from tpuzip_torch.device import resolve
from tpuzip_torch.kernels import range_coder, range_decoder
from tpuzip_torch.kernels.range_decoder import (CHUNK_STEPS,
                                                pack_chunk_index,
                                                parse_chunk_index)

MAGIC = b"TPZ1"
MAGIC_CORPUS = b"TPZC"
CODECS = {"lz4": 1, "rle": 2, "ari": 3, "bwt": 4, "deflate": 5, "bwtdc": 6,
          "lz4p": 7, "bin": 8, "apm": 9}
CODEC_IDS = {v: k for k, v in CODECS.items()}
ARI_DEFAULTS = (8, 1 << 13)   # (increment, threshold) without a trailer
HEADER = 26                   # bytes before the length table

# where ROADMAP.md (queue 1) ports each codec that is not here yet
_ROADMAP_ITEM = {"bwt": 7, "bwtdc": 8, "bin": 9, "apm": 9, "lz4": 12,
                 "lz4p": 12, "rle": 12, "deflate": 13}


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpuzip_torch yet (ROADMAP.md, queue 1, "
        f"item {item})")


def _check_codec(codec: str) -> None:
    if codec in _ROADMAP_ITEM:
        raise not_ported(f"codec {codec!r}", _ROADMAP_ITEM[codec])
    if codec != "ari":
        raise ValueError(f"unknown codec {codec!r}")


def compress(data: bytes, codec: str = "ari", block_size: int = 1 << 16,
             device="cuda", config: Config | None = None,
             block_checksums: bool = False) -> bytes:
    """Compress a corpus into a tpz container on `device`.

    `config.codec.ari` supplies the model knobs; values other than the
    defaults are recorded in the container (flag bit 2).
    block_checksums=True adds an Adler-32 per block (flag bit 0)."""
    _check_codec(codec)
    config = config or Config()
    inc, thr = config.codec.ari.increment, config.codec.ari.threshold
    check_knobs(inc, thr)
    dev = resolve(device)
    blocks_np, lengths_np = blk.chunk(data, block_size)
    nb = blocks_np.shape[0]
    blocks = torch.from_numpy(blocks_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    streams, slens, deltas = range_coder.ari_encode_indexed(
        blocks, lengths, increment=inc, threshold=thr)
    slens_np = slens.cpu().numpy().astype(np.int64)
    if slens_np.max(initial=0) > streams.shape[1]:
        raise ValueError("ari stream longer than its row capacity "
                         f"{streams.shape[1]}: knobs ({inc}, {thr})")
    # download only the used prefix of the rows
    width = int(slens_np.max(initial=0))
    comp_np = streams[:, :width].cpu().numpy()
    deltas_np = deltas.cpu().numpy()
    blobs = []
    for i in range(nb):
        nci = (int(lengths_np[i]) + CHUNK_STEPS - 1) // CHUNK_STEPS
        idx = pack_chunk_index(deltas_np[i, :nci])
        blobs.append(struct.pack("<I", len(idx)) + idx
                     + comp_np[i, : slens_np[i]].tobytes())
    flags = 2 | (1 if block_checksums else 0)
    if (inc, thr) != ARI_DEFAULTS:
        flags |= 4
    hdr = bytearray(MAGIC)
    hdr.append(CODECS[codec])
    hdr.append(flags)
    hdr += struct.pack("<IIQI", block_size, nb, len(data), zlib.adler32(data))
    hdr += np.array([len(p) for p in blobs], "<u4").tobytes()
    if block_checksums:
        hdr += adler32_batch(blocks, lengths).cpu().numpy().astype(
            "<u4").tobytes()
    if flags & 4:
        hdr += struct.pack("<HI", inc, thr)
    return bytes(hdr) + b"".join(blobs)


def _parse_header(container: bytes):
    """Validate the header and length tables (tpuzip's checks, same error
    classes).  Returns (block_size, nb, orig_len, a32, clens, block_sums,
    (increment, threshold), payload offset)."""
    if container[:4] == MAGIC_CORPUS:
        raise not_ported("the TPZC corpus container", 11)
    if container[:4] != MAGIC:
        raise HeaderError("bad tpz magic")
    if len(container) < 6 or container[4] not in CODEC_IDS:
        raise HeaderError("unknown codec id "
                          f"{container[4] if len(container) > 4 else None}")
    codec = CODEC_IDS[container[4]]
    _check_codec(codec)
    flags = container[5]
    if not flags & 2:
        raise not_ported("an ari container without the chunk index", 15)
    try:
        block_size, nb, orig_len, a32 = struct.unpack_from("<IIQI",
                                                           container, 6)
    except struct.error as e:
        raise HeaderError(f"truncated tpz header: {e}") from None
    if len(container) < HEADER + 4 * nb:
        raise BlockLengthError("container truncated in length table")
    off = HEADER
    clens = np.frombuffer(container, np.uint32, nb, off).astype(np.int64)
    off += 4 * nb
    block_sums = None
    if flags & 1:
        if len(container) < off + 4 * nb:
            raise BlockLengthError("container truncated in checksum table")
        block_sums = np.frombuffer(container, np.uint32, nb, off)
        off += 4 * nb
    knobs = ARI_DEFAULTS
    if flags & 4:
        if len(container) < off + 6:
            raise BlockLengthError("container truncated in codec params")
        knobs = struct.unpack_from("<HI", container, off)
        off += 6
    nc_full = (block_size + CHUNK_STEPS - 1) // CHUNK_STEPS
    cap = 4 + 3 * nc_full + encode_cap(block_size)
    if off + int(clens.sum()) != len(container):
        raise BlockLengthError(
            "container payload length disagrees with the length table"
            if off + int(clens.sum()) < len(container) else
            "container truncated: payload shorter than length table claims")
    if (clens > cap).any():
        raise BlockLengthError("declared block length exceeds codec bound")
    return block_size, nb, orig_len, a32, clens, block_sums, knobs, off


def decompress(container: bytes, device="cuda") -> bytes:
    """Decode a tpz ari container on `device`; checks the per-block and
    corpus Adler-32 as tpuzip does."""
    (block_size, nb, orig_len, a32, clens, block_sums, (inc, thr),
     off) = _parse_header(container)
    try:
        check_knobs(inc, thr)
    except ValueError as e:
        raise HeaderError(str(e)) from None
    dev = resolve(device)
    olens = np.clip(orig_len - np.arange(nb, dtype=np.int64) * block_size,
                    0, block_size)
    nc_full = (block_size + CHUNK_STEPS - 1) // CHUNK_STEPS
    cap_s = encode_cap(block_size)
    deltas = np.zeros((nb, nc_full), np.int32)
    spans = np.zeros((nb, 2), np.int64)   # stream offset, stream length
    starts = off + np.concatenate([[0], np.cumsum(clens)[:-1]]) if nb else []
    for i in range(nb):
        p, n = int(starts[i]), int(clens[i])
        if n < 4:
            if n != 0:
                raise BlockLengthError(f"ari block {i} shorter than header")
            continue
        (idxlen,) = struct.unpack_from("<I", container, p)
        if 4 + idxlen > n:
            raise BlockLengthError(f"ari block {i}: index overruns payload")
        nci = (int(olens[i]) + CHUNK_STEPS - 1) // CHUNK_STEPS
        try:
            deltas[i, :nci] = parse_chunk_index(
                container[p + 4 : p + 4 + idxlen], nci)
        except ValueError as e:
            raise CorruptStreamError([i]) from e
        if n - 4 - idxlen > cap_s:
            raise CorruptStreamError([i])
        spans[i] = (p + 4 + idxlen, n - 4 - idxlen)
    # upload only the used prefix of the rows: bytes past a row read as 0
    streams = np.zeros((nb, int(spans[:, 1].max(initial=0))), np.uint8)
    for i in range(nb):
        p, n = spans[i]
        streams[i, :n] = np.frombuffer(container, np.uint8, n, p)
    syms = range_decoder.ari_decode_indexed(
        torch.from_numpy(streams).to(dev), torch.from_numpy(deltas).to(dev),
        torch.from_numpy(olens.astype(np.int32)).to(dev),
        increment=inc, threshold=thr)[:, :block_size]
    if block_sums is not None:
        got = adler32_batch(syms, torch.from_numpy(olens).to(dev))
        bad = np.nonzero(got.cpu().numpy() != block_sums)[0]
        if bad.size:
            raise CorruptStreamError(bad)
    # every block is full except the tail (the chunking invariant)
    data = syms.cpu().numpy().reshape(-1)[:orig_len].tobytes()
    if a32 and zlib.adler32(data) != a32:
        raise ChecksumError(f"corpus Adler-32 mismatch: "
                            f"{zlib.adler32(data):#x} != {a32:#x}")
    return data
