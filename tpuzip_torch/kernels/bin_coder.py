"""Binary adaptive range coder over byte blocks (codecs bin and apm): the
CUDA kernels' wrappers and their plain PyTorch versions.

Port of tpuzip/kernels/bin_coder.py: ``_bin_kernel`` (encode) with the
host compaction of ``bin_encode_streams``, and ``_bin_decode_kernel``
(its step ``_bin_decode_step``).  A block of n bytes is 8n bits, coded
MSB-first one bit a step with the shift-update model p0 (``model_bits``
precision, ``rate`` shift) or, with ``use_apm``, with p0 refined through
the 33-cell APM gate (12-bit cells, shift 5); the range split's
denominator is a power of two.  The stream is the renormalisation bytes,
then the 4 bytes of the final ``low`` big-endian, exactly the oracle
chain's.  The container's chunk index holds the bytes consumed in each
CHUNK bits; the decoder starts chunk k at ``4 + sum(deltas[:k])`` and reads
a byte at or past the row's width as 0, as the TPU decoder's windows do.

The plain versions carry the u32 coder state in int64 masked to 32 bits
(torch on the CPU has no u32 arithmetic).
"""

from __future__ import annotations

import ctypes

import torch

from tpuzip_torch.codecs.bin_apm import (APM_BITS, APM_RATE, APM_SLOTS,
                                         bits_to_bytes, bytes_to_bits,
                                         check_knobs, encode_cap)
from tpuzip_torch.kernels import _build
from tpuzip_torch.kernels.range_decoder import BOT, MASK, TOP, chunk_starts

CHUNK = 256   # bits per chunk-index entry
MAX_DELTA = 4 * CHUNK + 4


def gate_init(b: int, device) -> torch.Tensor:
    """(b, APM_SLOTS) int64 cells: slot s starts at s * 4096 / 32."""
    s = torch.arange(APM_SLOTS, dtype=torch.int64, device=device)
    cells = (s * (1 << APM_BITS) // (APM_SLOTS - 1)).clamp(
        1, (1 << APM_BITS) - 1)
    return cells.repeat(b, 1)


def _bin_update(p, bit, top, rate):
    """The shift update of a probability of 0 scaled by `top`, clamped to
    [1, top-1]; bit is bool."""
    p = torch.where(bit, p - (p >> rate), p + ((top - p) >> rate))
    return torch.where(p >= top, top - 1, p).clamp(min=1)


class _Model:
    """The per-row state of the plain coders: p0 and, on the rows that use
    it, the APM gate.  The knobs may differ from row to row (ints, or (B,)
    tensors), so one plain run can hold several kernel launches."""

    def __init__(self, b: int, model_bits, rate, use_apm, device):
        def row(v, dtype):
            return torch.as_tensor(v, dtype=dtype, device=device).expand(b)

        bits, self.rate = row(model_bits, torch.int64), row(rate, torch.int64)
        self.apm = row(use_apm, torch.bool)
        self.any_apm = bool(self.apm.any())
        self.top = 1 << bits                # p0's scale
        # the range split's denominator: 2^bits, or the gate's 2^12
        self.denom_bits = torch.where(self.apm, APM_BITS, bits)
        self.denom = 1 << self.denom_bits
        self.p0 = self.top >> 1
        self.gate = gate_init(b, device) if self.any_apm else None

    def split(self):
        """p(bit = 0) scaled by the denominator; remembers the gate slot
        that the update of this bit adapts."""
        if not self.any_apm:
            return self.p0
        p0 = self.p0
        scaled = p0 * (APM_SLOTS - 1)
        idx = (scaled >> APM_BITS).clamp(max=APM_SLOTS - 2)
        frac = scaled & ((1 << APM_BITS) - 1)
        ab = torch.gather(self.gate, 1, torch.stack([idx, idx + 1], 1))
        pp = (ab[:, 0] * ((1 << APM_BITS) - frac) + ab[:, 1] * frac
              ) >> APM_BITS
        self.last = (idx + (frac >= (1 << (APM_BITS - 1))))[:, None]
        return torch.where(self.apm, pp.clamp(1, (1 << APM_BITS) - 1), p0)

    def update(self, bit, active):
        self.p0 = torch.where(active, _bin_update(self.p0, bit, self.top,
                                                  self.rate), self.p0)
        if self.any_apm:
            cell = torch.gather(self.gate, 1, self.last)
            new = _bin_update(cell, bit[:, None], 1 << APM_BITS, APM_RATE)
            self.gate = self.gate.scatter(
                1, self.last, torch.where((active & self.apm)[:, None], new,
                                          cell))


def _code(low, rng, bit, split, m: _Model):
    """The range split of one bit and its carryless renormalisation ->
    (low, rng, the bytes shifted out (0..4), low before the shift).  The
    shifted bytes are the top ones of that low, most significant first."""
    r = rng >> m.denom_bits
    low = (low + r * torch.where(bit, split, 0)) & MASK
    rng = r * torch.where(bit, m.denom - split, split)
    before = low
    count = torch.zeros_like(low)
    for _ in range(4):
        settled = ((low ^ (low + rng)) & MASK) < TOP
        force = (rng < BOT) & ~settled
        shift = settled | force
        rng = torch.where(force, (-low) & (BOT - 1), rng)
        low = torch.where(shift, (low << 8) & MASK, low)
        rng = torch.where(shift, (rng << 8) & MASK, rng)
        count += shift
    return low, rng, count, before


def bin_encode_indexed_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                             model_bits=12, rate=5, use_apm=False):
    """Lane-vectorised replica of the encoder step.  blocks (B, n) u8,
    lengths (B,) in bytes -> (streams (B, 4n+64) u8 zero-filled, stream
    lengths (B,) i32, deltas (B, ceil(8n/CHUNK)) i32).  A stream longer
    than its row reports its true length and keeps the bytes that fit.
    The knobs are ints or (B,) tensors (a knob pair a row)."""
    b, n = blocks.shape
    dev = blocks.device
    cap = encode_cap(8 * n)
    nc = -(-8 * n // CHUNK)
    nbits = 8 * lengths.to(torch.int64).clamp(0, n)
    steps = int(nbits.max()) if b else 0
    bits = bytes_to_bits(blocks)[:, :steps].bool()
    active_at = torch.arange(steps, device=dev) < nbits[:, None]
    m = _Model(b, model_bits, rate, use_apm, dev)
    # column `cap` collects the writes of rows that emit nothing
    out = torch.zeros((b, cap + 1), dtype=torch.uint8, device=dev)
    counts = torch.zeros((b, nc * CHUNK), dtype=torch.int32, device=dev)
    k4 = torch.arange(4, device=dev)
    low = torch.zeros(b, dtype=torch.int64, device=dev)
    rng = torch.full((b,), MASK, dtype=torch.int64, device=dev)
    pos = torch.zeros(b, dtype=torch.int64, device=dev)
    for t in range(steps):
        active, bit = active_at[:, t], bits[:, t]
        low2, rng2, count, before = _code(low, rng, bit, m.split(), m)
        count = torch.where(active, count, 0)
        at = torch.where(k4 < count[:, None], pos[:, None] + k4, cap)
        out.scatter_(1, at.clamp(max=cap), ((before[:, None] >> (24 - 8 * k4))
                                            & 0xFF).to(torch.uint8))
        pos += count
        counts[:, t] = count
        low = torch.where(active, low2, low)
        rng = torch.where(active, rng2, rng)
        m.update(bit, active)
    # finish(): the 4 bytes of low, most significant first
    out.scatter_(1, (pos[:, None] + k4).clamp(max=cap),
                 ((low[:, None] >> (24 - 8 * k4)) & 0xFF).to(torch.uint8))
    deltas = counts.reshape(b, nc, CHUNK).sum(2, dtype=torch.int32)
    return out[:, :cap].contiguous(), (pos + 4).to(torch.int32), deltas


def bin_decode_indexed_plain(streams: torch.Tensor,
                             deltas: torch.Tensor | None,
                             nbits: torch.Tensor, model_bits=12, rate=5,
                             use_apm=False,
                             nc: int | None = None) -> torch.Tensor:
    """Lane-vectorised replica of ``_bin_decode_step``.  streams (B, CAP)
    u8, deltas (B, NC) i32, nbits (B,) i32 -> (B, NC*CHUNK/8) u8 bytes,
    bits 0 past each row's nbits.  The knobs are ints or (B,) tensors.
    deltas=None decodes `nc` chunks without the index: the read position
    runs on from 4 and a byte at or past the row width reads as the row's
    last byte (tpuzip.codecs.bin_apm.decode_bits clips its index to the
    row); with the index such a byte reads as 0."""
    b, cap = streams.shape
    indexed = deltas is not None
    nc = deltas.shape[1] if indexed else nc
    dev = streams.device
    nb = nbits.to(torch.int64).clamp(0, nc * CHUNK)
    steps = min(nc * CHUNK, -(-int(nb.max()) // CHUNK) * CHUNK) if b else 0
    bits = torch.zeros((b, nc * CHUNK), dtype=torch.bool, device=dev)
    active_at = torch.arange(steps, device=dev) < nb[:, None]
    if indexed:
        # a byte at or past the row width reads as 0: 4 zero columns
        padded = torch.cat([streams, streams.new_zeros((b, 4))], 1)
        last = cap
        starts = chunk_starts(deltas)
    else:
        padded, last = streams, cap - 1
    padded = padded.to(torch.int64)
    k4 = torch.arange(4, device=dev)
    shifts = 24 - 8 * k4

    def word(at):   # stream bytes at .. at+3, big-endian
        return (torch.gather(padded, 1, (at[:, None] + k4).clamp(max=last))
                << shifts).sum(1)

    m = _Model(b, model_bits, rate, use_apm, dev)
    code = word(torch.zeros(b, dtype=torch.int64, device=dev))
    pos = torch.full((b,), 4, dtype=torch.int64, device=dev)
    low = torch.zeros(b, dtype=torch.int64, device=dev)
    rng = torch.full((b,), MASK, dtype=torch.int64, device=dev)
    for t in range(steps):
        if indexed and t % CHUNK == 0:   # rebase on the chunk index
            pos = starts[:, t // CHUNK]
        active = active_at[:, t]
        split = m.split()
        r = rng >> m.denom_bits
        v = torch.minimum(((code - low) & MASK) // r, m.denom - 1)
        bit = v >= split
        low2, rng2, count, _ = _code(low, rng, bit, split, m)
        count = torch.where(active, count, 0)
        # shift in `count` bytes: the next 4 of the stream, from the top
        code = ((code << (8 * count)) | (word(pos) >> (32 - 8 * count))
                ) & MASK
        pos = pos + count
        low = torch.where(active, low2, low)
        rng = torch.where(active, rng2, rng)
        m.update(bit, active)
        bits[:, t] = bit & active
    return bits_to_bytes(bits)


def _lib(name: str):
    lib = _build.load(name)
    fn = getattr(lib, f"tpz_{name}")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp, vp, ci, ci, vp, ci, vp, vp, ci, ci, ci, ci, vp]
                       if name == "bin_encode" else
                       [vp, vp, vp, ci, ci, ci, vp, ci, ci, ci, vp])
        fn.restype = ci
    return fn


def _check(blocks: torch.Tensor, *others: torch.Tensor) -> bool:
    """Common argument checks; True for a CUDA call, False for the CPU."""
    if not all(t.device == blocks.device for t in others):
        raise ValueError("the tensors must share a device")
    if blocks.device.type == "cpu":
        return False
    if blocks.device.type != "cuda":
        raise ValueError(f"no bin coder kernel for device {blocks.device}")
    if not all(t.is_contiguous() for t in (blocks, *others)):
        raise ValueError("the bin coder kernels take contiguous tensors")
    return True


def bin_encode_indexed(blocks: torch.Tensor, lengths: torch.Tensor,
                       model_bits: int = 12, rate: int = 5,
                       use_apm: bool = False):
    """bin/apm encode with the chunk index: blocks (B, n) u8, lengths (B,)
    i32 in bytes -> (streams (B, 4n+64) u8, stream_lens (B,) i32, deltas
    (B, ceil(8n/256)) i32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/bin_encode.cu on the current stream (no synchronisation)."""
    check_knobs(model_bits, rate)
    if blocks.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError("bin_encode_indexed takes u8 blocks and i32 lengths")
    if blocks.dim() != 2 or lengths.shape != blocks.shape[:1]:
        raise ValueError(f"shape mismatch: blocks {tuple(blocks.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if not _check(blocks, lengths):
        return bin_encode_indexed_plain(blocks, lengths, model_bits, rate,
                                        use_apm)
    b, n = blocks.shape
    cap = encode_cap(8 * n)
    nc = -(-8 * n // CHUNK)
    dev = blocks.device
    streams = torch.zeros((b, cap), dtype=torch.uint8, device=dev)
    stream_lens = torch.empty(b, dtype=torch.int32, device=dev)
    deltas = torch.empty((b, nc), dtype=torch.int32, device=dev)
    if b == 0:
        return streams, stream_lens, deltas
    fn = _lib("bin_encode")
    with torch.cuda.device(dev):
        err = fn(blocks.data_ptr(), lengths.data_ptr(), b, n,
                 streams.data_ptr(), cap, stream_lens.data_ptr(),
                 deltas.data_ptr(), nc, model_bits, rate, int(use_apm),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "bin_encode")
    bin_encode_indexed.launches += 1
    return streams, stream_lens, deltas


def bin_decode_indexed(streams: torch.Tensor, deltas: torch.Tensor,
                       nbits: torch.Tensor, model_bits: int = 12,
                       rate: int = 5, use_apm: bool = False) -> torch.Tensor:
    """Chunk-indexed bin/apm decode: streams (B, CAP) u8, deltas (B, NC)
    i32, nbits (B,) i32 -> (B, NC*32) u8 bytes, bits 0 past each nbits.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/bin_decode.cu on the current stream (no synchronisation)."""
    check_knobs(model_bits, rate)
    if (streams.dtype != torch.uint8 or deltas.dtype != torch.int32
            or nbits.dtype != torch.int32):
        raise TypeError("bin_decode_indexed takes u8 streams, i32 deltas "
                        "and i32 nbits")
    b, cap = streams.shape
    if deltas.dim() != 2 or deltas.shape[0] != b or nbits.shape != (b,):
        raise ValueError(f"shape mismatch: streams {tuple(streams.shape)}, "
                         f"deltas {tuple(deltas.shape)}, nbits "
                         f"{tuple(nbits.shape)}")
    if not _check(streams, deltas, nbits):
        return bin_decode_indexed_plain(streams, deltas, nbits, model_bits,
                                        rate, use_apm)
    out = launch_decode(streams, deltas, nbits, deltas.shape[1], model_bits,
                        rate, use_apm)
    if out.numel():
        bin_decode_indexed.launches += 1
    return out


def launch_decode(streams, deltas, nbits, nc: int, model_bits: int,
                  rate: int, use_apm: bool) -> torch.Tensor:
    """csrc/bin_decode.cu on the current stream (no synchronisation) into a
    new (B, nc*CHUNK/8) u8 tensor, with the chunk index or, deltas=None,
    without it.  Launches nothing for an empty output.  The callers count
    the launches."""
    b, cap = streams.shape
    out = torch.empty((b, nc * CHUNK // 8), dtype=torch.uint8,
                      device=streams.device)
    if out.numel() == 0:
        return out
    fn = _lib("bin_decode")
    with torch.cuda.device(streams.device):
        err = fn(streams.data_ptr(),
                 None if deltas is None else deltas.data_ptr(),
                 nbits.data_ptr(), b, cap, nc, out.data_ptr(), model_bits,
                 rate, int(use_apm), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "bin_decode")
    return out


bin_encode_indexed.launches = 0
bin_decode_indexed.launches = 0
