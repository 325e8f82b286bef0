"""Adaptive range ENCODER: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of tpuzip/kernels/range_coder.py (``_ari_encode_kernel`` plus the
stream compaction and finish bytes of ``_encode_lanes_packed_core``).
Both return, per block, exactly what ``ari_encode_lanes_packed_indexed``
returns: the complete oracle stream (renorm bytes, then the 4 finish bytes
of ``low``), zero-filled to the row capacity; its length (renorm bytes +
4, so an empty block has length 4); and the bytes emitted in each run of
CHUNK_STEPS symbols (the container's chunk index).  Format: bit-exact
tpuzip.oracle.ari.
"""

from __future__ import annotations

import ctypes

import torch

from tpuzip_torch.codecs.ari import check_knobs, encode_cap
from tpuzip_torch.kernels import _build
from tpuzip_torch.kernels.range_decoder import (
    CHUNK_STEPS, MASK, chunk_deltas, cum_range, model_init, model_update,
    plain_steps, renorm_round)

LANES = 128       # tpuzip's lane-group bounds, kept for its batching rule
MAX_LANES = 1024


def lane_width(b: int) -> int:
    """Smallest power-of-two lane width >= b, in [LANES, MAX_LANES]."""
    w = LANES
    while w < b and w < MAX_LANES:
        w *= 2
    return w


def ari_encode_indexed_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                             increment: int = 8, threshold: int = 1 << 13):
    """Lane-vectorised replica of the encoder step.  blocks (B, N) u8,
    lengths (B,) -> (streams (B, 2N+64) u8, stream_lens (B,) i32,
    deltas (B, ceil(N/64)) i32).  A stream longer than its row reports its
    true length and keeps only the bytes that fit."""
    b, n = blocks.shape
    dev = blocks.device
    cap = encode_cap(n)
    nc = -(-n // CHUNK_STEPS)
    lens = lengths.to(torch.int64).clamp(0, n)
    steps = plain_steps(lens, n)
    # column `cap` collects the writes of rows that emit nothing
    out = torch.zeros((b, cap + 1), dtype=torch.uint8, device=dev)
    counts = torch.zeros((b, nc * CHUNK_STEPS), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    syms = blocks[:, :steps].to(torch.int64)
    low = torch.zeros(b, dtype=torch.int64, device=dev)
    rng = torch.full((b,), MASK, dtype=torch.int64, device=dev)
    pos = torch.zeros(b, dtype=torch.int64, device=dev)
    cum, tot = model_init(b, dev)
    for t in range(steps):
        active = lens > t
        sym = syms[:, t]
        lo, hi = cum_range(cum, sym)
        r = rng // tot
        low2 = (low + r * lo) & MASK
        rng2 = r * (hi - lo)
        start = pos
        for _ in range(4):
            low2, rng2, emit, top = renorm_round(low2, rng2, active)
            out[rows, torch.where(emit, pos.clamp(max=cap), cap)] = \
                top.to(torch.uint8)
            pos = pos + emit
        counts[:, t] = (pos - start).to(torch.int32)
        low = torch.where(active, low2, low)
        rng = torch.where(active, rng2, rng)
        cum, tot = model_update(cum, tot, sym, active, increment, threshold)
    # finish(): the 4 bytes of low, most significant first
    for k in range(4):
        out[rows, (pos + k).clamp(max=cap)] = \
            ((low >> (24 - 8 * k)) & 0xFF).to(torch.uint8)
    streams = out[:, :cap].contiguous()
    deltas = chunk_deltas(counts.T).T.contiguous()
    return streams, (pos + 4).to(torch.int32), deltas


def _lib():
    lib = _build.load("ari_encode")
    fn = lib.tpz_ari_encode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def ari_encode_indexed(blocks: torch.Tensor, lengths: torch.Tensor,
                       increment: int = 8, threshold: int = 1 << 13):
    """ari encode with the chunk index: blocks (B, N) u8, lengths (B,) i32
    -> (streams (B, 2N+64) u8, stream_lens (B,) i32, deltas (B, NC) i32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/ari_encode.cu on the current stream (no synchronisation)."""
    check_knobs(increment, threshold)
    if blocks.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError("ari_encode_indexed takes u8 blocks and i32 lengths")
    if blocks.dim() != 2 or lengths.shape != blocks.shape[:1]:
        raise ValueError(f"shape mismatch: blocks {tuple(blocks.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if blocks.device != lengths.device:
        raise ValueError("blocks and lengths must share a device")
    if blocks.device.type == "cpu":
        return ari_encode_indexed_plain(blocks, lengths, increment,
                                        threshold)
    if blocks.device.type != "cuda":
        raise ValueError(f"no ari_encode for device {blocks.device}")
    if not (blocks.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("ari_encode_indexed takes contiguous tensors")
    b, n = blocks.shape
    cap = encode_cap(n)
    nc = -(-n // CHUNK_STEPS)
    dev = blocks.device
    streams = torch.zeros((b, cap), dtype=torch.uint8, device=dev)
    stream_lens = torch.empty(b, dtype=torch.int32, device=dev)
    deltas = torch.empty((b, nc), dtype=torch.int32, device=dev)
    if b == 0:
        return streams, stream_lens, deltas
    fn = _lib()
    with torch.cuda.device(dev):
        err = fn(blocks.data_ptr(), lengths.data_ptr(), b, n,
                 streams.data_ptr(), cap, stream_lens.data_ptr(),
                 deltas.data_ptr(), nc, increment, threshold,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ari_encode")
    ari_encode_indexed.launches += 1
    return streams, stream_lens, deltas


ari_encode_indexed.launches = 0
