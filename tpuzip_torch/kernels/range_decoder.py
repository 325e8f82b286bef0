"""Adaptive range DECODERS: the CUDA kernels' wrappers, their plain
PyTorch versions, and the chunk index that all of them read.

Port of tpuzip/kernels/range_decoder.py.  The container carries, per
block, a chunk index: the stream bytes the coder consumed in each run of
CHUNK_STEPS symbols.  The TPU decoder needed it to prepack per-chunk
windows (Mosaic has no per-lane gather); on the card a warp reads its own
stream, so the index only fixes where each chunk starts reading:
``start[k] = 4 + exclusive_cumsum(deltas)[k]``.  Within a chunk the read
position advances by the bytes pulled, and a byte at or past the row's
width reads as 0 — the TPU kernels' semantics exactly (build_windows
clamps to the width, with 4 zero bytes of padding).

tpuzip has three decode kernels of that one function: v3 and v2 carry
the cumulative table and update it in place, v1 (algo="dot") carries the
frequency table and rebuilds the cumulative one every step, because the
TPU's vector unit had no scan across sublanes and its matrix unit did it.
On the card the rebuild is a warp scan on the chain of every step, so all
three run csrc/ari_decode.cu, whose step updates the cumulative table in
place.  The plain versions keep both states: ari_decode_indexed_plain the
cumulative one, ari_decode_dot_indexed_plain tpuzip's v1 step.

Torch on the CPU has no add, shift or compare for torch.uint32, so the
plain versions carry the u32 coder state in int64 masked to 32 bits.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuzip_torch.codecs.ari import check_knobs
from tpuzip_torch.kernels import _build

CHUNK_STEPS = 64          # symbols per index entry (index granularity)
MAX_DELTA = 4 * CHUNK_STEPS + 4   # 4 bytes a symbol + the 4 finish bytes
TOP = 1 << 24
BOT = 1 << 16
MASK = 0xFFFFFFFF
W_BUCKETS = (16, 24, 40, 72)  # window words per chunk (72 covers the
#                               absolute worst case 4*64+4 bytes)


def window_words(max_delta: int) -> int:
    """Smallest window bucket covering a chunk that consumed max_delta
    bytes (word reads reach byte index delta-1+3)."""
    need = (max_delta + 2) // 4 + 1
    for w in W_BUCKETS:
        if w >= need:
            return w
    raise ValueError(f"chunk delta {max_delta} exceeds 4*CHUNK_STEPS")


# ---------------------------------------------------------------------------
# Chunk index
# ---------------------------------------------------------------------------

def chunk_deltas(counts: torch.Tensor) -> torch.Tensor:
    """Renorm counts (N, L) -> per-chunk consumed bytes (N/CHUNK_STEPS, L)
    int32.  Decode consumes the same bytes at the same steps."""
    n, lanes = counts.shape
    if n % CHUNK_STEPS:
        raise ValueError(f"{n} steps is not a multiple of {CHUNK_STEPS}")
    return counts.to(torch.int32).reshape(
        n // CHUNK_STEPS, CHUNK_STEPS, lanes).sum(dim=1, dtype=torch.int32)


def pack_chunk_index(deltas: np.ndarray) -> bytes:
    """u8 stream; a delta >= 255 is escaped as (255, lo, hi)."""
    deltas = np.asarray(deltas)
    if deltas.size == 0:
        return b""
    if deltas.max(initial=0) < 255:  # overwhelmingly common: pure u8 cast
        return deltas.astype(np.uint8).tobytes()
    out = bytearray()
    for d in deltas:
        d = int(d)
        if d < 255:
            out.append(d)
        else:
            out += bytes((255, d & 0xFF, d >> 8))
    return bytes(out)


def parse_chunk_index(blob: bytes, nc: int,
                      max_delta: int = MAX_DELTA) -> np.ndarray:
    """Inverse of pack_chunk_index; ValueError on a truncated index, one
    with trailing bytes, or a delta past max_delta (the ari bound by
    default; the bin coder's 256-bit chunks pass 4*256+4)."""
    if len(blob) == nc and (nc == 0 or b"\xff" not in blob):
        return np.frombuffer(blob, np.uint8).astype(np.int32)
    deltas = np.zeros(nc, np.int32)
    i = 0
    for k in range(nc):
        if i >= len(blob):
            raise ValueError("chunk index truncated")
        d = blob[i]
        i += 1
        if d == 255:
            if i + 2 > len(blob):
                raise ValueError("chunk index truncated")
            d = blob[i] | (blob[i + 1] << 8)
            i += 2
            if d > max_delta:
                raise ValueError(f"chunk delta {d} exceeds {max_delta}")
        deltas[k] = d
    if i != len(blob):
        raise ValueError("chunk index has trailing bytes")
    return deltas


def chunk_starts(deltas: torch.Tensor) -> torch.Tensor:
    """(..., NC) deltas -> (..., NC) int64 stream position of each chunk's
    first read: 4 (past the code word) + the bytes of the chunks before."""
    d = deltas.to(torch.int64)
    return 4 + torch.cumsum(d, dim=-1) - d


def build_windows(comp: torch.Tensor, starts: torch.Tensor,
                  w: int) -> torch.Tensor:
    """comp (CAP, L) u8 lane-major streams, starts (NC, L) byte positions
    -> (NC*w, L) windows: word j of chunk k holds stream bytes
    starts[k]+4j .. +4j+3 big-endian, positions clamped to CAP (which reads
    4 zero bytes).  Values are u32 held in int64.  The CUDA decoder needs
    no windows; this is the TPU layout, kept for the parity tests."""
    cap, lanes = comp.shape
    c = torch.cat([comp, comp.new_zeros((4, lanes))]).to(torch.int64)
    sliding = (c[:-3] << 24) | (c[1:-2] << 16) | (c[2:-1] << 8) | c[3:]
    nc = starts.shape[0]
    idx = (starts.to(torch.int64)[:, None, :]
           + 4 * torch.arange(w, device=comp.device)[None, :, None])
    idx = idx.clamp(0, cap).reshape(nc * w, lanes)
    return torch.gather(sliding, 0, idx)


# ---------------------------------------------------------------------------
# The model and the coder's renormalization, shared with the encoder
# ---------------------------------------------------------------------------

def model_init(b: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform model: inclusive cumulative table C[k] = k+1, total 256."""
    cum = torch.arange(1, 257, dtype=torch.int64, device=device).repeat(b, 1)
    return cum, torch.full((b,), 256, dtype=torch.int64, device=device)


def packed_cum_to_cum(table) -> torch.Tensor:
    """tpuzip's u16-pair-packed model state (128, L) i32 — row p holds
    C[2p] in its low half and C[2p+1] in its high half — -> the port's
    (L, 256) int64 inclusive cumulative table."""
    t = torch.from_numpy(np.array(table, dtype=np.int64)) & MASK
    pairs = torch.stack([t & 0xFFFF, t >> 16], dim=1)   # (128, 2, L)
    return pairs.reshape(256, -1).T.contiguous()


def model_update(cum, tot, sym, active, increment: int, threshold: int):
    """freq[sym] += increment (C[k] += increment for k >= sym), then the
    oracle's halving ((f+1)>>1 on every frequency) on the rows whose total
    reached threshold.  Rows where `active` is False keep their model."""
    iota = torch.arange(256, device=cum.device)
    grow = (iota[None, :] >= sym[:, None]) & active[:, None]
    cum = cum + grow * increment
    tot = tot + active * increment
    scale = active & (tot >= threshold)
    if bool(scale.any()):   # every ~(threshold-256)/increment symbols
        freq = torch.diff(cum, dim=1, prepend=cum.new_zeros((cum.shape[0], 1)))
        halved = torch.cumsum((freq + 1) >> 1, dim=1)
        cum = torch.where(scale[:, None], halved, cum)
        tot = torch.where(scale, halved[:, -1], tot)
    return cum, tot


def cum_range(cum, sym):
    """(C[sym-1], C[sym]) per row, with C[-1] = 0."""
    hi = torch.gather(cum, 1, sym[:, None]).squeeze(1)
    lo = torch.gather(cum, 1, (sym - 1).clamp(min=0)[:, None]).squeeze(1)
    return torch.where(sym > 0, lo, 0), hi


def renorm_round(low, rng, active):
    """One of the <= 4 carryless renorm rounds: returns the new state, the
    rows that shift a byte out (encoder emits / decoder pulls) and the top
    byte of low before the shift."""
    settled = (low ^ ((low + rng) & MASK)) < TOP
    force = ~settled & (rng < BOT)
    rng = torch.where(force, (-low) & (BOT - 1), rng)
    shift = (settled | force) & active
    top = low >> 24
    low = torch.where(shift, (low << 8) & MASK, low)
    rng = torch.where(shift, (rng << 8) & MASK, rng)
    return low, rng, shift, top


def plain_steps(lens: torch.Tensor, n: int) -> int:
    """Steps a plain version runs: the longest length rounded up to
    CHUNK_STEPS (the outputs do not depend on the steps after it)."""
    if lens.numel() == 0:
        return 0
    longest = int(lens.max())
    return min(n, -(-longest // CHUNK_STEPS) * CHUNK_STEPS)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _plain_decode(streams: torch.Tensor, deltas: torch.Tensor | None,
                  lengths: torch.Tensor, model, step,
                  nc: int | None = None) -> torch.Tensor:
    """The coder loop of the plain decoders: the rebase on the chunk index,
    the two divisions and the byte pulls.  `model` is the state (table,
    total) before the first step; ``step(model, v, active)`` returns (sym,
    C[sym-1], C[sym], model after the update).  deltas=None decodes
    without the index, `nc` chunks of symbols: the read position runs on
    from 4, and a byte at or past the row width reads as the row's last
    byte (tpuzip.codecs.ari.decode clips its index to the row); with the
    index such a byte reads as 0."""
    b, cap = streams.shape
    indexed = deltas is not None
    nc = deltas.shape[1] if indexed else nc
    dev = streams.device
    lens = lengths.to(torch.int64).clamp(0, nc * CHUNK_STEPS)
    out = torch.zeros((b, nc * CHUNK_STEPS), dtype=torch.uint8, device=dev)
    if indexed:
        # a byte at or past the row width reads as 0: 4 zero columns
        padded = torch.cat([streams, streams.new_zeros((b, 4))], 1)
        last = cap
    else:
        padded, last = streams, cap - 1
    padded = padded.to(torch.int64)
    rows = torch.arange(b, device=dev)
    code = torch.zeros(b, dtype=torch.int64, device=dev)
    for k in range(4):
        code = (code << 8) | padded[:, min(k, last)]
    pos = torch.full((b,), 4, dtype=torch.int64, device=dev)
    if indexed:
        starts = chunk_starts(deltas)
    low = torch.zeros(b, dtype=torch.int64, device=dev)
    rng = torch.full((b,), MASK, dtype=torch.int64, device=dev)
    for t in range(plain_steps(lens, nc * CHUNK_STEPS)):
        if indexed and t % CHUNK_STEPS == 0:   # rebase on the chunk index
            pos = starts[:, t // CHUNK_STEPS]
        active = lens > t
        tot = model[1]
        r = rng // tot
        v = torch.minimum(((code - low) & MASK) // r, tot - 1)
        sym, lo, hi, model = step(model, v, active)
        low2 = (low + r * lo) & MASK
        rng2 = r * (hi - lo)
        for _ in range(4):
            low2, rng2, pull, _top = renorm_round(low2, rng2, active)
            byte = padded[rows, pos.clamp(max=last)]
            code = torch.where(pull, ((code << 8) | byte) & MASK, code)
            pos = pos + pull
        low = torch.where(active, low2, low)
        rng = torch.where(active, rng2, rng)
        out[:, t] = torch.where(active, sym, 0).to(torch.uint8)
    return out


def _cum_step(increment: int, threshold: int):
    """The step of the plain decoder on cumulative state: tpuzip's
    ``_decode_step_cum`` + ``_apply_halving_gated`` (the v2 kernel; v3
    computes the same function on a packed table)."""

    def step(model, v, active):
        cum, tot = model
        # find_value: the entries above v are exactly the indices >= sym
        sym = 256 - (cum > v[:, None]).sum(dim=1)
        lo, hi = cum_range(cum, sym)
        return sym, lo, hi, model_update(cum, tot, sym, active, increment,
                                         threshold)

    return step


def ari_decode_indexed_plain(streams: torch.Tensor, deltas: torch.Tensor,
                             lengths: torch.Tensor, increment: int = 8,
                             threshold: int = 1 << 13) -> torch.Tensor:
    """Lane-vectorised replica of tpuzip's chunk-indexed lane decoder
    (_cum_step).  streams (B, CAP) u8 zero-padded, deltas (B, NC) i32,
    lengths (B,) -> (B, NC*64) u8 symbols, 0 past each length."""
    return _plain_decode(streams, deltas, lengths,
                         model_init(streams.shape[0], streams.device),
                         _cum_step(increment, threshold))


def decode_batch_plain(comp: torch.Tensor, lengths: torch.Tensor, out_n: int,
                       increment: int = 8,
                       threshold: int = 1 << 13) -> torch.Tensor:
    """Plain version of decode_batch: the decoder of _cum_step with no
    chunk index.  comp (B, CAP) u8, lengths (B,) -> (B, out_n) u8."""
    nc = -(-out_n // CHUNK_STEPS)
    out = _plain_decode(comp, None, lengths,
                        model_init(comp.shape[0], comp.device),
                        _cum_step(increment, threshold), nc)
    return out[:, :out_n].contiguous()


def ari_decode_dot_indexed_plain(streams: torch.Tensor, deltas: torch.Tensor,
                                 lengths: torch.Tensor, increment: int = 8,
                                 threshold: int = 1 << 13) -> torch.Tensor:
    """Lane-vectorised replica of tpuzip's ``_decode_step`` (the v1
    kernel ``_ari_decode_kernel``, ``algo="dot"``): the model is the
    FREQUENCY table, and every step rebuilds the inclusive cumulative
    table from it.  The TPU took that as ``tri @ freq`` on its matrix unit
    with the frequencies split into bytes to stay exact in bf16; the cumsum
    here is exact in int64.  Same arguments and output as
    ari_decode_indexed_plain, and the same function of them."""

    def step(model, v, active):
        freq, tot = model
        cum = torch.cumsum(freq, dim=1)
        sym = (cum <= v[:, None]).sum(dim=1)
        lo, hi = cum_range(cum, sym)
        freq = freq.scatter_add(1, sym[:, None], (active * increment)[:, None])
        tot = tot + active * increment
        scale = active & (tot >= threshold)
        if bool(scale.any()):   # every ~(threshold-256)/increment symbols
            halved = (freq + 1) >> 1
            freq = torch.where(scale[:, None], halved, freq)
            tot = torch.where(scale, halved.sum(dim=1), tot)
        return sym, lo, hi, (freq, tot)

    b, dev = streams.shape[0], streams.device
    model = (torch.ones((b, 256), dtype=torch.int64, device=dev),
             torch.full((b,), 256, dtype=torch.int64, device=dev))
    return _plain_decode(streams, deltas, lengths, model, step)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    """The C entry tpz_ari_decode of csrc/ari_decode.cu."""
    fn = _build.load("ari_decode").tpz_ari_decode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, ci, ci, vp, ci, ci, vp]
        fn.restype = ci
    return fn


def _check(name: str, streams, deltas, lengths, increment: int,
           threshold: int) -> None:
    """The argument checks of both wrappers."""
    check_knobs(increment, threshold)
    b, _cap = streams.shape
    if (streams.dtype != torch.uint8 or deltas.dtype != torch.int32
            or lengths.dtype != torch.int32):
        raise TypeError(f"{name} takes u8 streams, i32 deltas and i32 "
                        "lengths")
    if deltas.dim() != 2 or deltas.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"shape mismatch: streams {tuple(streams.shape)}, "
                         f"deltas {tuple(deltas.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if not (streams.device == deltas.device == lengths.device):
        raise ValueError("streams, deltas and lengths must share a device")
    if streams.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} for device {streams.device}")


def _launch(streams, deltas, lengths, increment: int, threshold: int,
            nc: int | None = None) -> torch.Tensor:
    """csrc/ari_decode.cu on the current stream (no synchronisation) into
    a new (B, NC*64) u8 tensor; deltas=None decodes nc chunks without the
    index.  An empty batch launches nothing and gives an empty tensor."""
    if not all(t.is_contiguous() for t in (streams, deltas, lengths)
               if t is not None):
        raise ValueError("ari_decode takes contiguous tensors")
    b, cap = streams.shape
    nc = deltas.shape[1] if deltas is not None else nc
    out = torch.empty((b, nc * CHUNK_STEPS), dtype=torch.uint8,
                      device=streams.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(streams.device):
        err = fn(streams.data_ptr(),
                 None if deltas is None else deltas.data_ptr(),
                 lengths.data_ptr(), b, cap, nc, out.data_ptr(), increment,
                 threshold, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ari_decode")
    return out


def ari_decode_indexed(streams: torch.Tensor, deltas: torch.Tensor,
                       lengths: torch.Tensor, increment: int = 8,
                       threshold: int = 1 << 13,
                       algo: str | None = None) -> torch.Tensor:
    """Chunk-indexed ari decode: streams (B, CAP) u8, deltas (B, NC) i32,
    lengths (B,) i32 -> (B, NC*64) u8 symbols, 0 past each length.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/ari_decode.cu on the current stream (no synchronisation).

    `algo` is the counterpart of ``ari_decode_lanes(algo=...)``: None,
    "packed" and "cum" (one function, and one kernel here: its u32 table
    takes every knob pair) or "dot", which runs ari_decode_dot_indexed.
    The runner never passes it."""
    if algo == "dot":
        return ari_decode_dot_indexed(streams, deltas, lengths, increment,
                                      threshold)
    if algo not in (None, "packed", "cum"):
        raise ValueError(f"unknown ari decode algo {algo!r}")
    _check("ari_decode_indexed", streams, deltas, lengths, increment,
           threshold)
    if streams.device.type == "cpu":
        return ari_decode_indexed_plain(streams, deltas, lengths,
                                        increment, threshold)
    out = _launch(streams, deltas, lengths, increment, threshold)
    if out.numel():
        ari_decode_indexed.launches += 1
    return out


ari_decode_indexed.launches = 0


def ari_decode_dot_indexed(streams: torch.Tensor, deltas: torch.Tensor,
                           lengths: torch.Tensor, increment: int = 8,
                           threshold: int = 1 << 13) -> torch.Tensor:
    """tpuzip's v1 decoder (algo="dot"): the same arguments and output as
    ari_decode_indexed, and the same function.  A CPU tensor runs
    ari_decode_dot_indexed_plain, the v1 step on frequency state; a CUDA
    tensor launches csrc/ari_decode.cu on the current stream (no
    synchronisation), counted here and not in ari_decode_indexed."""
    _check("ari_decode_dot_indexed", streams, deltas, lengths, increment,
           threshold)
    if streams.device.type == "cpu":
        return ari_decode_dot_indexed_plain(streams, deltas, lengths,
                                            increment, threshold)
    out = _launch(streams, deltas, lengths, increment, threshold)
    if out.numel():
        ari_decode_dot_indexed.launches += 1
    return out


ari_decode_dot_indexed.launches = 0


def decode_batch(comp: torch.Tensor, lengths: torch.Tensor, out_n: int,
                 increment: int = 8,
                 threshold: int = 1 << 13) -> torch.Tensor:
    """ari decode without the chunk index, tpuzip.codecs.ari.decode_batch:
    comp (B, CAP) u8 streams, CAP >= 1, lengths (B,) i32 symbols -> (B,
    out_n) u8, 0 past each length.  The read position runs on from byte 4,
    and a byte at or past CAP reads as the row's last byte, as tpuzip
    reads.

    A CPU tensor runs decode_batch_plain; a CUDA tensor launches
    csrc/ari_decode.cu in its mode without the index, on the current
    stream (no synchronisation)."""
    check_knobs(increment, threshold)
    if comp.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError("decode_batch takes u8 streams and i32 lengths")
    if comp.dim() != 2 or lengths.shape != comp.shape[:1]:
        raise ValueError(f"shape mismatch: comp {tuple(comp.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if comp.shape[1] < 1 or out_n < 0:
        raise ValueError(f"decode_batch needs rows of at least 1 byte and "
                         f"out_n >= 0 (comp {tuple(comp.shape)}, out_n "
                         f"{out_n})")
    if comp.device != lengths.device:
        raise ValueError("comp and lengths must share a device")
    if comp.device.type == "cpu":
        return decode_batch_plain(comp, lengths, out_n, increment, threshold)
    if comp.device.type != "cuda":
        raise ValueError(f"no decode_batch for device {comp.device}")
    out = _launch(comp, None, lengths, increment, threshold,
                  -(-out_n // CHUNK_STEPS))
    if out.numel():
        decode_batch.launches += 1
    return out[:, :out_n].contiguous()


decode_batch.launches = 0
