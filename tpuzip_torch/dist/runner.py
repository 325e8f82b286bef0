"""The tpz container, lz4, rle, lz4p, deflate, ari, bwt, bwtdc, bin and apm
codecs:
compress and decompress on one device, compress_from_device and
decompress(to_device=True) for data that lives on it, and the TPZC corpus
container of superbatches (compress_corpus, decompress_corpus).

Port of those codecs' parts of tpuzip/dist/runner.py, byte for byte the
same container:

  magic 'TPZ1' | codec u8 | flags u8 | block_size u32 LE | num_blocks u32 LE
  | orig_len u64 LE | adler32(orig) u32 LE | comp_lens u32[num_blocks] LE
  | [flags&1: block_adler u32[num_blocks] LE]
  | [flags&4: <HI> the model knobs when not the codec's defaults:
      (increment, threshold) not (8, 8192), or for bin/apm
      (model_bits, rate) not (12, 5)]
  | payloads, per block: lz4, rle, lz4p, deflate: [stream] (flag 2 is never
    set);
    bin, apm from compress_from_device: [stream] (flag 2 clear);
    the others with flags&2, the chunk index:
      ari:   [u32 idx_len][chunk index][ari stream]
      bwt:   [u32 origin][u32 idx_len][idx][ari(mtf(L)) stream]
      bwtdc: [u32 origin][u32 dc_len][u32 idx_len][idx][ari(dc(L)) stream]
      bin, apm: [u32 idx_len][index of 256-bit chunks][bit coder stream]
    or, with flags&2 clear (tpuzip's run_job writes them; decoded only):
      ari: [stream]; bwt: [u32 origin][stream];
      bwtdc: [u32 origin][u32 dc_len][stream]; bin, apm: [stream]
      bwt with flags&8 (blocks above SEG_THRESHOLD):
            [u32 origin][u16 nseg][u32 seg], then per segment
            [u32 seg_olen][u32 idx_len][idx][stream], each segment MTF+ari
            coded with fresh state

The corpus is cut into blocks (core.blocks), the blocks go to the device as
one (B, block_size) batch, and every stage (BWT, MTF or DC, the coder)
runs on the whole batch at once.  The port runs on one device, so unlike
tpuzip it never pads the batch to a mesh width; it decodes tpuzip's padded
containers all the same.

  TPZC corpus container: 'TPZC' | count u32 LE | per superbatch:
  [len u64 LE][tpz container]

Each superbatch is one compress call, so device memory is bounded by the
superbatch and the pipeline depth, not by the corpus.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpuzip_torch.codecs import bin_apm, bwt, dc
from tpuzip_torch.codecs import deflate as cdeflate
from tpuzip_torch.codecs import lz4 as clz4
from tpuzip_torch.codecs import lz4p as clz4p
from tpuzip_torch.codecs import rle as crle
from tpuzip_torch.codecs.ari import check_knobs, encode_cap
from tpuzip_torch.core import blocks as blk
from tpuzip_torch.core.checksum import adler32_batch
from tpuzip_torch.core.config import Config
from tpuzip_torch.device import resolve
from tpuzip_torch.kernels import (bin_coder, deflate_coder, lz4_chain,
                                  lz4_coder, lz4_dense, lz4p_coder, mtf_scan,
                                  range_coder, range_decoder, rle_coder)
from tpuzip_torch.kernels.range_decoder import (CHUNK_STEPS,
                                                pack_chunk_index,
                                                parse_chunk_index)
from tpuzip_torch.oracle import adler as oadler
from tpuzip_torch.runtime.errors import (BlockLengthError, ChecksumError,
                                         CorruptStreamError, HeaderError)

MAGIC = b"TPZ1"
MAGIC_CORPUS = b"TPZC"
CODECS = {"lz4": 1, "rle": 2, "ari": 3, "bwt": 4, "deflate": 5, "bwtdc": 6,
          "lz4p": 7, "bin": 8, "apm": 9}
CODEC_IDS = {v: k for k, v in CODECS.items()}
ARI_DEFAULTS = (8, 1 << 13)   # (increment, threshold) without a trailer
HEADER = 26                   # bytes before the length table
# payload bytes before [u32 idx_len]
HEAD = {"ari": 0, "bwt": 4, "bwtdc": 8, "bin": 0, "apm": 0}
SEG_HEAD = 10                 # <IHI> origin, nseg, seg of a flag-8 block
SEG_THRESHOLD = 1 << 20       # bwt blocks above this segment the entropy stage
PARALLEL_ADLER = 8 << 20      # corpora from here on sum in PARTS threads
PARTS = 4
BIN_CODECS = ("bin", "apm")
# one plain stream a block, flag 2 never set
LZ_CODECS = ("lz4", "rle", "lz4p", "deflate")


def not_ported(what: str, item) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpuzip_torch yet (ROADMAP.md, queue 1, "
        f"item {item})")


def _check_codec(codec: str) -> None:
    if codec not in HEAD and codec not in LZ_CODECS:
        raise ValueError(f"unknown codec {codec!r}")


def corpus_adler32(data) -> int:
    """The container's Adler-32 of the whole corpus (tpuzip's
    corpus_adler32): from PARALLEL_ADLER bytes on, zlib.adler32 of PARTS
    parts on as many threads (it releases the GIL on large buffers),
    folded by oracle.adler.combine; below it, zlib.adler32."""
    if len(data) < PARALLEL_ADLER:
        return zlib.adler32(data)
    step = -(-len(data) // PARTS)
    mv = memoryview(data)
    parts = [mv[o : o + step] for o in range(0, len(data), step)]
    with ThreadPoolExecutor(max_workers=len(parts)) as ex:
        sums = list(ex.map(zlib.adler32, parts))
    total = 1
    for a, part in zip(sums, parts):
        total = oadler.combine(total, a, len(part))
    return total


def _knob_defaults(codec: str) -> tuple[int, int]:
    return bin_apm.KNOB_DEFAULTS if codec in BIN_CODECS else ARI_DEFAULTS


def _check_knobs(codec: str, a: int, b: int) -> None:
    """ValueError for knobs the codec's range coder cannot carry."""
    (bin_apm.check_knobs if codec in BIN_CODECS else check_knobs)(a, b)


def _seg_geometry(n: int) -> tuple[int, int]:
    """(seg_size, nseg) of a big block's entropy stage: <= 128 segments,
    seg_size a multiple of 256 (tpuzip's, so the containers agree)."""
    seg = -(-n // 128)
    seg = -(-seg // 256) * 256
    return seg, -(-n // seg)


def _download(streams, slens, deltas, what: str):
    """An indexed encoder's (streams, stream lengths, deltas) -> the same on
    the host, the streams cut to the longest one."""
    slens_np = slens.cpu().numpy().astype(np.int64)
    if slens_np.max(initial=0) > streams.shape[1]:
        raise ValueError(f"{what} stream longer than its row capacity "
                         f"{streams.shape[1]}")
    # download only the used prefix of the rows
    width = int(slens_np.max(initial=0))
    return (streams[:, :width].cpu().numpy(), slens_np,
            deltas.cpu().numpy())


def _ari_encode(syms: torch.Tensor, lens: torch.Tensor, inc: int, thr: int):
    """ari with the chunk index of every row -> (streams (B, w) u8 on the
    host, cut to the longest stream; stream lengths; deltas)."""
    return _download(*range_coder.ari_encode_indexed(
        syms, lens, increment=inc, threshold=thr),
        f"ari (knobs ({inc}, {thr}))")


def _indexed(lens_np, comp_np, slens_np, deltas_np, k: int,
             chunk: int = CHUNK_STEPS) -> bytes:
    """[u32 idx_len][chunk index][stream] of row k, whose coder took
    lens_np[k] steps, `chunk` steps an index entry."""
    nci = (int(lens_np[k]) + chunk - 1) // chunk
    idx = pack_chunk_index(deltas_np[k, :nci])
    return (struct.pack("<I", len(idx)) + idx
            + comp_np[k, : slens_np[k]].tobytes())


def _encode_bwt_segmented(L, origins, lengths_np, inc, thr) -> list[bytes]:
    """The flag-8 payloads: each block's L column cut into segments, each
    MTF+ari coded with fresh state as one row of a (B*nseg, seg) batch."""
    nb, n = L.shape
    seg, nseg = _seg_geometry(n)
    Lseg = torch.nn.functional.pad(L, (0, seg * nseg - n))
    Lseg = Lseg.reshape(nb * nseg, seg)
    seg_lens = np.clip(lengths_np.astype(np.int64)[:, None]
                       - seg * np.arange(nseg)[None, :], 0, seg
                       ).astype(np.int32).reshape(-1)
    sl = torch.from_numpy(seg_lens).to(L.device)
    comp_np, slens_np, deltas_np = _ari_encode(
        mtf_scan.mtf_batch(Lseg, sl), sl, inc, thr)
    blobs = []
    for i in range(nb):
        parts = [struct.pack("<IHI", int(origins[i]), nseg, seg)]
        for k in range(i * nseg, (i + 1) * nseg):
            parts.append(struct.pack("<I", int(seg_lens[k])))
            parts.append(_indexed(seg_lens, comp_np, slens_np, deltas_np, k))
        blobs.append(b"".join(parts))
    return blobs


def _encode_bwtdc(L, origins, lengths, inc: int, thr: int) -> list[bytes]:
    """The bwtdc payloads: DC of each block's L column, then ari of the DC
    stream (rows cut to the longest: a row's ari stream does not depend on
    the row width)."""
    comp, dlens = dc.encode_batch(L, lengths)
    dlens_np = dlens.cpu().numpy()
    width = int(dlens_np.max(initial=0))
    coded = _ari_encode(comp[:, :width].contiguous(), dlens, inc, thr)
    return [struct.pack("<II", int(origins[i]), int(dlens_np[i]))
            + _indexed(dlens_np, *coded, i) for i in range(L.shape[0])]


def _encode_bin(blocks, lengths, lengths_np, bits: int, rate: int,
                use_apm: bool) -> list[bytes]:
    """The bin/apm payloads: each block's bits through the binary model (or
    the APM gate over it), with the index of 256-bit chunks."""
    coded = _download(*bin_coder.bin_encode_indexed(
        blocks, lengths, bits, rate, use_apm), f"bin (knobs ({bits}, {rate}))")
    nbits = 8 * lengths_np.astype(np.int64)
    return [_indexed(nbits, *coded, i, bin_coder.CHUNK)
            for i in range(blocks.shape[0])]


def _compact(comp, clens):
    """Streams compacted on the device (each row's first clen bytes, in
    order) and downloaded once: (clens on the host, the payload)."""
    keep = (torch.arange(comp.shape[1], device=comp.device)[None, :]
            < clens[:, None])
    return (clens.cpu().numpy().astype(np.int64),
            comp[keep].cpu().numpy().tobytes())


def _encode_blocks(codec: str, blocks, lengths, lengths_np, knobs,
                   lz_encode=None, bin_index: bool = True):
    """Every block's payload, the codec's part of compress and
    compress_from_device: blocks (B, n) u8 and lengths (B,) i32 on the
    device -> (the flags the payloads set: 2 the chunk index, 8 the
    segmented bwt stage; their lengths; the payload).  lz4, rle, lz4p and
    deflate run lz_encode(blocks, lengths) -> (comp, clens); bin and apm
    write the
    stream alone where bin_index is False."""
    inc, thr = knobs
    nb, n = blocks.shape
    if codec in LZ_CODECS:
        return (0, *_compact(*lz_encode(blocks, lengths)))
    if codec in BIN_CODECS and not bin_index:
        streams, slens, _ = bin_coder.bin_encode_indexed(
            blocks, lengths, inc, thr, codec == "apm")
        return (0, *_compact(streams, slens))
    flags = 2
    if codec == "ari":
        coded = _ari_encode(blocks, lengths, inc, thr)
        blobs = [_indexed(lengths_np, *coded, i) for i in range(nb)]
    elif codec in BIN_CODECS:
        blobs = _encode_bin(blocks, lengths, lengths_np, inc, thr,
                            codec == "apm")
    else:
        L, origins = bwt.encode_batch(blocks, lengths)
        origins = origins.cpu().numpy()
        if codec == "bwtdc":   # never segmented (flag 8 is bwt's alone)
            blobs = _encode_bwtdc(L, origins, lengths, inc, thr)
        elif n > SEG_THRESHOLD:
            flags |= 8
            blobs = _encode_bwt_segmented(L, origins, lengths_np, inc, thr)
        else:
            coded = _ari_encode(mtf_scan.mtf_batch(L, lengths), lengths,
                                inc, thr)
            blobs = [struct.pack("<I", int(origins[i]))
                     + _indexed(lengths_np, *coded, i) for i in range(nb)]
    return flags, [len(p) for p in blobs], b"".join(blobs)


def _header(codec: str, flags: int, block_size: int, nb: int,
            orig_len: int, a32: int, clens, block_sums, knobs) -> bytes:
    """The container's header, length table, per-block sums (flags & 1)
    and knob trailer (flags & 4)."""
    hdr = bytearray(MAGIC)
    hdr.append(CODECS[codec])
    hdr.append(flags)
    hdr += struct.pack("<IIQI", block_size, nb, orig_len, a32)
    hdr += np.array(clens, "<u4").tobytes()
    if flags & 1:
        hdr += np.asarray(block_sums).astype("<u4").tobytes()
    if flags & 4:
        hdr += struct.pack("<HI", *knobs)
    return bytes(hdr)


def compress(data: bytes, codec: str = "lz4", block_size: int | None = None,
             device="cuda", config: Config | None = None,
             block_checksums: bool = False) -> bytes:
    """Compress a corpus into a tpz container on `device`.

    block_size=None takes config.codec.bwt.block_size for bwt and bwtdc
    (1 MiB by default) and config.mesh.block_size otherwise (64 KiB), as
    tpuzip does.  `config.codec.ari` supplies the model knobs, (increment,
    threshold) or for bin/apm (bin_bits, bin_rate); values other than the
    defaults are recorded in the container (flag bit 2), for lz4, rle and
    lz4p too, which do not use them (tpuzip's rule).  `config.codec.lz4`'s
    hash_log sizes the lz4 and lz4p encoders' table (clamped to 4..24, else
    16); its max_chain > 1 runs tpuzip's chained lz4 encoder
    (kernels/lz4_chain.py; lz4p ignores it); its device_encode=True, which
    comes first, runs tpuzip's device encoder (kernels/lz4_dense.py): lz4
    at that hash_log as it is, lz4p at 15 with its columns unsplit
    (kernels/lz4p_coder.py).  deflate writes the bytes of tpuzip's C++
    encoder at `config.codec.deflate`'s mode (dynamic, fixed or stored;
    any other raises ValueError) and max_chain (kernels/deflate_coder.py).
    block_checksums=True adds an Adler-32 per block (flag bit 0)."""
    _check_codec(codec)
    config = config or Config()
    lz4_cfg = config.codec.lz4
    deflate_cfg = config.codec.deflate
    if codec == "deflate":
        mode = cdeflate.mode_id(deflate_cfg.mode)
    if block_size is None:
        block_size = (config.codec.bwt.block_size if codec in ("bwt", "bwtdc")
                      else config.mesh.block_size)
    ari = config.codec.ari
    knobs = ((ari.bin_bits, ari.bin_rate) if codec in BIN_CODECS
             else (ari.increment, ari.threshold))
    if codec not in LZ_CODECS:   # tpuzip checks no knob a codec ignores
        _check_knobs(codec, *knobs)
    dev = resolve(device)
    blocks_np, lengths_np = blk.chunk(data, block_size)
    nb = blocks_np.shape[0]
    blocks = torch.from_numpy(blocks_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    def lz_encode(b, lens):
        if codec == "rle":
            return rle_coder.rle_encode_batch(b, lens)
        if codec == "deflate":
            return deflate_coder.deflate_encode_batch(
                b, lens, deflate_cfg.max_chain, mode)
        if codec == "lz4p":
            return lz4p_coder.lz4p_encode_batch(b, lens, lz4_cfg.hash_log,
                                                xla=lz4_cfg.device_encode)
        if lz4_cfg.device_encode:   # before max_chain, as tpuzip's runner
            return lz4_dense.lz4_dense_encode_batch(b, lens, lz4_cfg.hash_log)
        if lz4_cfg.max_chain > 1:
            return lz4_chain.lz4_chain_encode_batch(
                b, lens, lz4_cfg.hash_log, lz4_cfg.max_chain)
        return lz4_coder.lz4_encode_batch(b, lens, lz4_cfg.hash_log)

    flags, clens_np, payload = _encode_blocks(codec, blocks, lengths,
                                              lengths_np, knobs, lz_encode)
    flags |= (1 if block_checksums else 0) | (
        4 if knobs != _knob_defaults(codec) else 0)
    sums = (adler32_batch(blocks, lengths).cpu().numpy()
            if block_checksums else None)
    return _header(codec, flags, block_size, nb, len(data),
                   corpus_adler32(data), clens_np, sums, knobs) + payload


def _device_blocks(blocks, dev):
    """compress_from_device's blocks as a (B, n) u8 tensor on dev: a numpy
    array is uploaded, a tensor must lie there already."""
    if isinstance(blocks, np.ndarray):
        if blocks.dtype != np.uint8:
            raise TypeError(f"blocks must be uint8, not {blocks.dtype}")
        return torch.from_numpy(np.ascontiguousarray(blocks)).to(dev)
    if not torch.is_tensor(blocks):
        raise TypeError("blocks must be a tensor or a numpy array")
    if blocks.dtype != torch.uint8:
        raise TypeError(f"blocks must be uint8, not {blocks.dtype}")
    if blocks.device.type != dev.type or (
            dev.index is not None and blocks.device.index != dev.index):
        raise ValueError(f"blocks lie on {blocks.device}, not on {dev}: "
                         "move them there (no silent copy)")
    return blocks.contiguous()


def compress_from_device(blocks, lengths, codec: str = "lz4",
                         block_checksums: bool = False,
                         config: Config | None = None,
                         device="cuda") -> bytes:
    """Compress blocks that live on `device` into a tpz container
    (tpuzip's compress_from_device): the data leaves the device
    compressed, never raw.

    blocks: (B, n) u8 tensor on `device` (a numpy array is uploaded);
    lengths: (B,) valid bytes a block (a tensor on any device, an array or
    a list).  Every block but the last must be full, since the container
    implies the lengths from orig_len and n.  The bytes are tpuzip's:
    ari, bwt (flag 8 past SEG_THRESHOLD) and bwtdc take the indexed
    encoders; lz4 takes tpuzip's device encoder at hash_log 15, lz4p its
    parse in unsplit columns (blocks of at most 65536 bytes; a block
    without a match raises ValueError, fault 7) and rle its 256-byte
    segments, whatever the config says; bin and apm the bit coder
    at (12, 5), the stream alone.  Flag 4 and its trailer follow the ari
    knobs for every codec, as in tpuzip; for bin and apm that container
    would decode with the wrong model (tpuzip reads the trailer as their
    knobs), so they raise ValueError there.  deflate takes tpuzip's
    device rule (codecs.deflate.deflate_batch: a greedy parse at max_chain
    1, the code lengths in its oracle's order), whatever
    config.codec.deflate says.  The corpus Adler-32 is folded from the
    per-block sums."""
    _check_codec(codec)
    config = config or Config()
    dev = resolve(device)
    blocks = _device_blocks(blocks, dev)
    if blocks.dim() != 2:
        raise ValueError(f"blocks must be (B, n), not {tuple(blocks.shape)}")
    nb, n = blocks.shape
    if nb == 0:
        raise ValueError("compress_from_device needs at least one block")
    lengths_np = (lengths.cpu().numpy() if torch.is_tensor(lengths)
                  else np.asarray(lengths)).astype(np.int64).reshape(-1)
    if lengths_np.shape != (nb,) or (lengths_np[:-1] != n).any() or \
            not 0 <= lengths_np[-1] <= n:
        raise ValueError(
            "compress_from_device requires full blocks except the last "
            "(the container implies block lengths from orig_len)")
    ari = config.codec.ari
    knobs = (ari.increment, ari.threshold)
    flags = (1 if block_checksums else 0) | (
        4 if knobs != ARI_DEFAULTS else 0)
    if codec in BIN_CODECS:
        if flags & 4:
            raise ValueError(
                f"{codec}: tpuzip's compress_from_device writes the ari "
                f"knobs {knobs} in the trailer that decompress reads as "
                f"{codec}'s (model_bits, rate); its container would not "
                "decode, so the port refuses it")
        enc_knobs = bin_apm.KNOB_DEFAULTS
    else:
        enc_knobs = knobs
        if codec not in LZ_CODECS:
            _check_knobs(codec, *knobs)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
    sums = adler32_batch(blocks, lengths).cpu().numpy()
    a32 = 1
    for s, ln in zip(sums, lengths_np):
        a32 = oadler.combine(a32, int(s), int(ln))
    def lz_encode(b, lens):
        if codec == "rle":
            return rle_coder.rle_encode_segments_batch(b, lens)
        if codec == "deflate":
            return cdeflate.deflate_batch(b, lens)
        if codec == "lz4p":
            return lz4p_coder.lz4p_encode_batch(b, lens, xla=True)
        return lz4_dense.lz4_dense_encode_batch(b, lens, lz4_dense.HASH_LOG)
    more, clens_np, payload = _encode_blocks(
        codec, blocks, lengths, lengths_np, enc_knobs, lz_encode,
        bin_index=False)
    return _header(codec, flags | more, n, nb, int(lengths_np.sum()), a32,
                   clens_np, sums if block_checksums else None,
                   knobs) + payload


def _block_cap(codec: str, flags: int, block_size: int) -> int:
    """The largest payload a block of `codec` may declare (tpuzip's
    per-codec bound in its decompress)."""
    if codec == "lz4":
        return clz4.encode_cap(block_size)
    if codec == "rle":
        return crle.encode_cap(block_size)
    if codec == "lz4p":
        return clz4p.encode_cap(block_size)
    if codec == "deflate":
        return cdeflate.decode_cap(block_size)
    if codec == "bwt" and flags & 8:
        seg, nseg = _seg_geometry(block_size)
        nc_seg = (seg + CHUNK_STEPS - 1) // CHUNK_STEPS
        return SEG_HEAD + nseg * (8 + 3 * nc_seg + encode_cap(seg))
    if not flags & 2:   # no chunk index: the stream's own bound
        if codec in BIN_CODECS:
            return bin_apm.encode_cap(8 * block_size)
        return encode_cap(dc.encode_cap(block_size) if codec == "bwtdc"
                          else block_size)
    if codec in BIN_CODECS:
        nc_bits = (8 * block_size + bin_coder.CHUNK - 1) // bin_coder.CHUNK
        return bin_apm.encode_cap(8 * block_size) + 4 + 3 * nc_bits
    # ari symbols a block: its bytes, or for bwtdc its DC stream's
    width = dc.encode_cap(block_size) if codec == "bwtdc" else block_size
    nc_full = (width + CHUNK_STEPS - 1) // CHUNK_STEPS
    return HEAD[codec] + 4 + 3 * nc_full + encode_cap(width)


def _parse_header(container: bytes):
    """Validate the header and length tables (tpuzip's checks, same error
    classes).  Returns (codec, flags, block_size, nb, orig_len, a32, clens,
    block_sums, knobs, payload offset)."""
    if container[:4] != MAGIC:
        raise HeaderError("bad tpz magic")
    if len(container) < 6 or container[4] not in CODEC_IDS:
        raise HeaderError("unknown codec id "
                          f"{container[4] if len(container) > 4 else None}")
    codec = CODEC_IDS[container[4]]
    _check_codec(codec)
    flags = container[5]
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
    knobs = _knob_defaults(codec)
    if flags & 4:
        if len(container) < off + 6:
            raise BlockLengthError("container truncated in codec params")
        knobs = struct.unpack_from("<HI", container, off)
        off += 6
    if off + int(clens.sum()) != len(container):
        raise BlockLengthError(
            "container payload length disagrees with the length table"
            if off + int(clens.sum()) < len(container) else
            "container truncated: payload shorter than length table claims")
    if (clens > _block_cap(codec, flags, block_size)).any():
        raise BlockLengthError("declared block length exceeds codec bound")
    return (codec, flags, block_size, nb, orig_len, a32, clens, block_sums,
            knobs, off)


def _parse_indexed(container: bytes, p: int, n: int, olen: int,
                   cap_s: int, deltas_row: np.ndarray, i: int):
    """Parse [u32 idx_len][idx][stream] of block i (n bytes at p) into
    deltas_row; returns the stream's (offset, length)."""
    (idxlen,) = struct.unpack_from("<I", container, p)
    if 4 + idxlen > n:
        raise BlockLengthError(f"ari block {i}: index overruns payload")
    nci = (olen + CHUNK_STEPS - 1) // CHUNK_STEPS
    try:
        deltas_row[:nci] = parse_chunk_index(
            container[p + 4 : p + 4 + idxlen], nci)
    except ValueError as e:
        raise CorruptStreamError([i]) from e
    if n - 4 - idxlen > cap_s:
        raise CorruptStreamError([i])
    return p + 4 + idxlen, n - 4 - idxlen


def _parse_segmented(container: bytes, p: int, n: int, seg: int, nseg: int,
                     deltas: np.ndarray, spans: np.ndarray,
                     seg_lens: np.ndarray, i: int) -> int:
    """Parse the flag-8 payload of block i (n bytes at p) into rows
    i*nseg .. of deltas / spans / seg_lens; returns its origin."""
    cap_s = encode_cap(seg)
    if n < SEG_HEAD:
        raise CorruptStreamError([i])
    origin, ns, sg = struct.unpack_from("<IHI", container, p)
    if ns != nseg or sg != seg:
        raise CorruptStreamError([i])
    pos, end = p + SEG_HEAD, p + n
    for k in range(i * nseg, (i + 1) * nseg):
        if pos + 8 > end:
            raise CorruptStreamError([i])
        sl, idxlen = struct.unpack_from("<II", container, pos)
        pos += 8
        if sl > seg:
            raise CorruptStreamError([i])
        nci = (sl + CHUNK_STEPS - 1) // CHUNK_STEPS
        try:
            deltas[k, :nci] = parse_chunk_index(
                container[pos : min(pos + idxlen, end)], nci)
        except ValueError as e:
            raise CorruptStreamError([i]) from e
        pos += idxlen
        # 4 code bytes + the bytes the chunks pull (an empty segment still
        # carries its 4 finish bytes)
        slen = int(deltas[k].sum()) + 4
        if slen > cap_s or pos + slen > end:
            raise CorruptStreamError([i])
        spans[k] = (pos, slen)
        seg_lens[k] = sl
        pos += slen
    if pos != end:
        raise BlockLengthError(f"bwt block {i}: trailing payload bytes")
    return origin


def _decode_bin(container: bytes, starts, clens, olens, block_size: int,
                nb: int, bits: int, rate: int, use_apm: bool,
                dev) -> torch.Tensor:
    """bin/apm blocks -> (nb, block_size) u8 on `dev`.  A bad index raises
    parse_chunk_index's ValueError unwrapped, as tpuzip lets it escape."""
    chunk = bin_coder.CHUNK
    deltas = np.zeros((nb, (8 * block_size + chunk - 1) // chunk), np.int32)
    spans = np.zeros((nb, 2), np.int64)   # stream offset, length
    cap_s = bin_apm.encode_cap(8 * block_size)
    for i in range(nb):
        p, n = int(starts[i]), int(clens[i])
        if n == 0:
            continue
        idxlen = int.from_bytes(container[p : p + min(n, 4)], "little")
        if 4 + idxlen > n:
            raise CorruptStreamError([i])
        nci = (8 * int(olens[i]) + chunk - 1) // chunk
        deltas[i, :nci] = parse_chunk_index(
            container[p + 4 : p + 4 + idxlen], nci,
            max_delta=bin_coder.MAX_DELTA)
        if n - 4 - idxlen > cap_s:
            raise CorruptStreamError([i])
        spans[i] = (p + 4 + idxlen, n - 4 - idxlen)
    out = bin_coder.bin_decode_indexed(
        _upload_streams(container, spans, dev),
        torch.from_numpy(deltas).to(dev),
        torch.from_numpy((8 * olens).astype(np.int32)).to(dev),
        bits, rate, use_apm)
    return out[:, :block_size].contiguous()


def _upload_streams(container: bytes, spans: np.ndarray, dev):
    """(B, longest) u8 stream rows from the container on `dev`; a byte past
    a row's stream reads as 0."""
    streams = np.zeros((spans.shape[0], int(spans[:, 1].max(initial=0))),
                       np.uint8)
    for k, (p, n) in enumerate(spans):
        streams[k, :n] = np.frombuffer(container, np.uint8, n, p)
    return torch.from_numpy(streams).to(dev)


def _ari_decode(container, spans, deltas, lens, width, inc, thr, dev):
    """ari decode of every row -> (B, width) u8 symbols on `dev`."""
    syms = range_decoder.ari_decode_indexed(
        _upload_streams(container, spans, dev),
        torch.from_numpy(deltas).to(dev),
        torch.from_numpy(lens.astype(np.int32)).to(dev),
        increment=inc, threshold=thr)
    return syms[:, :width].contiguous()


def _decode_segmented(container, starts, clens, olens, block_size, nb,
                      inc, thr, dev) -> torch.Tensor:
    """Flag-8 bwt blocks -> (nb, block_size) u8 on `dev`."""
    seg, nseg = _seg_geometry(block_size)
    nc_seg = (seg + CHUNK_STEPS - 1) // CHUNK_STEPS
    deltas = np.zeros((nb * nseg, nc_seg), np.int32)
    spans = np.zeros((nb * nseg, 2), np.int64)
    seg_lens = np.zeros(nb * nseg, np.int64)
    origins = np.zeros(nb, np.int32)
    for i in range(nb):
        if clens[i]:
            origins[i] = _parse_segmented(
                container, int(starts[i]), int(clens[i]), seg, nseg, deltas,
                spans, seg_lens, i)
    sl = torch.from_numpy(seg_lens.astype(np.int32)).to(dev)
    syms = _ari_decode(container, spans, deltas, seg_lens, seg, inc, thr,
                       dev)
    L = mtf_scan.mtf_batch(syms, sl, decode=True)
    L = L.reshape(nb, nseg * seg)[:, :block_size]
    return bwt.decode_batch(L, torch.from_numpy(origins).to(dev),
                            torch.from_numpy(olens).to(dev))


def _decode_unindexed(container: bytes, codec: str, starts, clens, olens,
                      block_size: int, nb: int, knobs, dev) -> torch.Tensor:
    """The blocks of a container without the chunk index (flag 2 clear)
    -> (nb, block_size) u8 on `dev`, as tpuzip decodes them (its
    decompress, runner.py:1186-1299): each payload zero-filled to the
    codec's bound, the fields at its head read from there, and the stream
    decoded with no index by ari_decode.cu or bin_decode.cu."""
    head = {"bwt": 4, "bwtdc": 8}.get(codec, 0)
    cap = _block_cap(codec, 0, block_size)
    # the rows cut one zero column past the longest payload: past it the
    # decoders read the row's last byte, which is 0 in tpuzip's rows too
    width = min(cap, max(int(clens.max(initial=0)) + 1, head + 1))
    rows = np.zeros((nb, width), np.uint8)
    for i in range(nb):
        n = int(clens[i])
        rows[i, :n] = np.frombuffer(container, np.uint8, n, int(starts[i]))
    fields = rows[:, :head].copy().view("<i4")   # origin (and dc_len)
    streams = torch.from_numpy(np.ascontiguousarray(rows[:, head:])).to(dev)
    lens = torch.from_numpy(olens.astype(np.int32)).to(dev)
    if codec in BIN_CODECS:
        bits, rate = knobs
        return bin_apm.decode_batch(streams, lens, block_size, bits, rate,
                                    codec == "apm")
    # tpuzip decodes ari, bwt and bwtdc at the default knobs whatever
    # flag 4 says (jari.decode_batch / jari.decode take no knobs there):
    # its behaviour, mirrored
    if codec == "ari":
        return range_decoder.decode_batch(streams, lens, block_size)
    origins = torch.from_numpy(fields[:, 0].copy()).to(dev)
    if codec == "bwt":
        syms = range_decoder.decode_batch(streams, lens, block_size)
        return bwt.decode_batch(mtf_scan.mtf_batch(syms, lens, decode=True),
                                origins, lens)
    width_dc = dc.encode_cap(block_size)
    dlens_np = fields[:, 1].astype(np.int64)
    bad = np.nonzero((dlens_np < 0) | (dlens_np > width_dc))[0]
    if bad.size:
        raise CorruptStreamError(bad)
    dlens = torch.from_numpy(dlens_np.astype(np.int32)).to(dev)
    dstreams = range_decoder.decode_batch(streams, dlens, width_dc)
    L, _, err = dc.decode_batch(dstreams, dlens, block_size)
    bad = np.nonzero(err.cpu().numpy())[0]
    if bad.size:
        raise CorruptStreamError(bad)
    return bwt.decode_batch(L, origins, lens)


def _decode_lz(container: bytes, codec: str, starts, clens, olens,
               block_size: int, dev) -> torch.Tensor:
    """lz4, rle, lz4p or deflate blocks -> (nb, block_size) u8 on `dev`,
    with tpuzip's checks in its order: a decoded length that is not the
    block's (on a block with a stream and no error) raises ValueError, then
    a stream in error CorruptStreamError naming its blocks.  deflate has
    tpuzip's own rule: any block with a stream whose status is not its
    length, a corrupt one included, raises ValueError."""
    spans = np.stack([starts, clens], axis=1) if len(clens) \
        else np.zeros((0, 2), np.int64)
    streams = _upload_streams(container, spans, dev)
    lens = torch.from_numpy(clens.astype(np.int32)).to(dev)
    decode = {"lz4": lz4_coder.lz4_decode_batch,
              "rle": rle_coder.rle_decode_batch,
              "lz4p": lz4p_coder.lz4p_decode_batch,
              "deflate": deflate_coder.inflate_batch}[codec]
    out, status = decode(streams, lens, block_size)
    st = status.cpu().numpy()
    if codec == "deflate":
        bad = (st != olens) & (clens > 0)
        if bad.any():
            raise ValueError(
                f"deflate length mismatch at {np.nonzero(bad)[0][:8]}")
        return out
    err = st < 0
    bad = (np.where(st > 0, st, 0) != olens) & (clens > 0) & ~err
    if bad.any():
        raise ValueError(f"block length mismatch at {np.nonzero(bad)[0][:8]}")
    if err.any():
        raise CorruptStreamError(np.nonzero(err)[0])
    return out


def decompress(container: bytes, device="cuda", to_device: bool = False):
    """Decode a tpz container of a ported codec on `device`; checks the
    per-block and corpus Adler-32 as tpuzip does.

    to_device=True returns (blocks (B, block_size) u8 tensor on `device`,
    olens (B,) np.int64, orig_len) and downloads nothing: the per-block
    sums are still checked, the corpus checksum (it needs the bytes
    assembled on the host) is not, as in tpuzip."""
    (codec, flags, block_size, nb, orig_len, a32, clens, block_sums,
     (inc, thr), off) = _parse_header(container)
    if codec not in LZ_CODECS:   # these ignore the trailer's knobs
        try:
            _check_knobs(codec, inc, thr)
        except ValueError as e:
            raise HeaderError(str(e)) from None
    dev = resolve(device)
    olens = np.clip(orig_len - np.arange(nb, dtype=np.int64) * block_size,
                    0, block_size)
    starts = off + np.concatenate([[0], np.cumsum(clens)[:-1]]) if nb \
        else np.zeros(0, np.int64)
    if codec in LZ_CODECS:   # whatever the flags say, as tpuzip
        out = _decode_lz(container, codec, starts, clens, olens, block_size,
                         dev)
    elif codec == "bwt" and flags & 8:   # whatever flag 2 says, as tpuzip
        out = _decode_segmented(container, starts, clens, olens, block_size,
                                nb, inc, thr, dev)
    elif not flags & 2:
        out = _decode_unindexed(container, codec, starts, clens, olens,
                                block_size, nb, (inc, thr), dev)
    elif codec in BIN_CODECS:
        out = _decode_bin(container, starts, clens, olens, block_size, nb,
                          inc, thr, codec == "apm", dev)
    else:
        head = HEAD[codec]
        # ari symbols a block: its bytes, or for bwtdc its DC stream's
        width = dc.encode_cap(block_size) if codec == "bwtdc" else block_size
        nc_full = (width + CHUNK_STEPS - 1) // CHUNK_STEPS
        cap_s = encode_cap(width)
        deltas = np.zeros((nb, nc_full), np.int32)
        spans = np.zeros((nb, 2), np.int64)   # stream offset, length
        origins = np.zeros(nb, np.int32)
        sym_lens = olens if codec != "bwtdc" else np.zeros(nb, np.int64)
        for i in range(nb):
            p, n = int(starts[i]), int(clens[i])
            if n == 0:
                continue
            if n < head + 4:
                raise BlockLengthError(f"{codec} block {i} shorter than "
                                       "header")
            if codec == "bwtdc":
                origins[i], sym_lens[i] = struct.unpack_from("<II",
                                                             container, p)
                if sym_lens[i] > width:
                    raise CorruptStreamError([i])
            elif head:
                (origins[i],) = struct.unpack_from("<I", container, p)
            spans[i] = _parse_indexed(container, p + head, n - head,
                                      int(sym_lens[i]), cap_s, deltas[i], i)
        if codec == "bwtdc":
            # the DC streams, in rows cut to the longest
            nc = (int(sym_lens.max(initial=0)) + CHUNK_STEPS - 1) \
                // CHUNK_STEPS
            dstreams = _ari_decode(container, spans,
                                   np.ascontiguousarray(deltas[:, :nc]),
                                   sym_lens, nc * CHUNK_STEPS, inc, thr, dev)
            dlens = torch.from_numpy(sym_lens.astype(np.int32)).to(dev)
            L, _, err = dc.decode_batch(dstreams, dlens, block_size)
            bad = np.nonzero(err.cpu().numpy())[0]
            if bad.size:
                raise CorruptStreamError(bad)
            out = bwt.decode_batch(L, torch.from_numpy(origins).to(dev),
                                   torch.from_numpy(olens).to(dev))
        else:
            out = _ari_decode(container, spans, deltas, olens, block_size,
                              inc, thr, dev)
        if codec == "bwt":
            lens = torch.from_numpy(olens.astype(np.int32)).to(dev)
            out = bwt.decode_batch(mtf_scan.mtf_batch(out, lens, decode=True),
                                   torch.from_numpy(origins).to(dev), lens)
    if block_sums is not None:
        got = adler32_batch(out, torch.from_numpy(olens).to(dev))
        bad = np.nonzero(got.cpu().numpy() != block_sums)[0]
        if bad.size:
            raise CorruptStreamError(bad)
    if to_device:
        return out, olens, orig_len
    # every block is full except the tail (the chunking invariant)
    data = out.cpu().numpy().reshape(-1)[:orig_len].tobytes()
    if a32:
        got = corpus_adler32(data)
        if got != a32:
            raise ChecksumError(f"corpus Adler-32 mismatch: {got:#x} != "
                                f"{a32:#x}")
    return data


def compress_corpus(data: bytes, codec: str = "lz4",
                    block_size: int = 1 << 16,
                    superbatch: int | None = 8 << 20, pipeline: int = 2,
                    block_checksums: bool = False,
                    config: Config | None = None, device="cuda") -> bytes:
    """Compress a corpus as a TPZC sequence of superbatch containers
    (tpuzip's compress_corpus): each superbatch of `superbatch` bytes is
    one compress call, on a pool of `pipeline` threads, so one's host
    stages overlap another's device work and device memory is bounded by
    the superbatch.  superbatch=None takes config.mesh.blocks_per_chip
    blocks (one device).  Empty input is one empty superbatch."""
    if superbatch is None:
        superbatch = (config or Config()).mesh.blocks_per_chip * block_size
    resolve(device)
    pieces = [data[o : o + superbatch]
              for o in range(0, max(len(data), 1), superbatch)]
    out = [MAGIC_CORPUS, struct.pack("<I", len(pieces))]
    with ThreadPoolExecutor(max_workers=max(pipeline, 1)) as ex:
        for blob in ex.map(
                lambda p: compress(p, codec=codec, block_size=block_size,
                                   device=device, config=config,
                                   block_checksums=block_checksums),
                pieces):
            out.append(struct.pack("<Q", len(blob)))
            out.append(blob)
    return b"".join(out)


def decompress_corpus(blob: bytes, pipeline: int = 2,
                      device="cuda") -> bytes:
    """The inverse of compress_corpus, the superbatches decoded on a pool
    of `pipeline` threads.  A truncated blob or bytes after its last
    superbatch raise ValueError."""
    if blob[:4] != MAGIC_CORPUS:
        raise ValueError("not a tpz corpus container")
    if len(blob) < 8:
        raise ValueError("corpus container truncated")
    (count,) = struct.unpack_from("<I", blob, 4)
    pos, parts = 8, []
    for _ in range(count):
        if pos + 8 > len(blob):
            raise ValueError("corpus container truncated")
        (ln,) = struct.unpack_from("<Q", blob, pos)
        pos += 8
        if pos + ln > len(blob):
            raise ValueError("corpus container truncated")
        parts.append(blob[pos : pos + ln])
        pos += ln
    if pos != len(blob):
        raise ValueError("trailing bytes after corpus container")
    resolve(device)
    with ThreadPoolExecutor(max_workers=max(pipeline, 1)) as ex:
        return b"".join(ex.map(lambda c: decompress(c, device=device),
                               parts))
