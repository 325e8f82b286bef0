"""The binary adaptive model and the APM/SSE gate over byte blocks (the
"bin" and "apm" codecs): stream capacity, knobs and the bit order.

Port of tpuzip/codecs/bin_apm.py.  Format: tpuzip.oracle.ari's
BinaryModel (bin.rs) or ApmGate over it (apm.rs) driven through the
carryless range coder, one adaptive model a block, the bytes coded
MSB-first.  The per-bit coder itself is kernels/bin_coder.
"""

from __future__ import annotations

import torch

APM_BITS = 12
APM_SLOTS = 33
APM_RATE = 5        # the gate's adaptation shift (tpuzip's apm_rate)
KNOB_DEFAULTS = (12, 5)   # (model_bits, rate) without a container trailer
MAX_MODEL_BITS = 16       # r = range >> bits stays >= 1 (range >= 2^16)


def encode_cap(n_bits: int) -> int:
    """Row capacity of the stream of n_bits bits (4n+64 for n bytes)."""
    return n_bits // 2 + 64


def check_knobs(model_bits: int, rate: int) -> None:
    """Raise ValueError for a model the range coder cannot carry."""
    if not (1 <= model_bits <= MAX_MODEL_BITS and 0 <= rate <= 31):
        raise ValueError(
            f"bin knobs out of range: bits={model_bits}, rate={rate} (need "
            f"1 <= bits <= {MAX_MODEL_BITS} and 0 <= rate <= 31)")


def bytes_to_bits(blocks: torch.Tensor) -> torch.Tensor:
    """(B, n) u8 -> (B, 8n) u8 of 0/1, MSB-first within each byte."""
    b, n = blocks.shape
    shifts = torch.arange(7, -1, -1, device=blocks.device)
    return ((blocks[:, :, None] >> shifts) & 1).to(torch.uint8).reshape(
        b, 8 * n)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(B, 8n) u8 of 0/1 -> (B, n) u8, MSB-first."""
    b, n8 = bits.shape
    w = 1 << torch.arange(7, -1, -1, device=bits.device)
    return (bits.reshape(b, n8 // 8, 8).to(torch.int64) * w).sum(2).to(
        torch.uint8)


def decode_batch(comp: torch.Tensor, lengths: torch.Tensor, out_n: int,
                 model_bits: int = 12, rate: int = 5,
                 use_apm: bool = False) -> torch.Tensor:
    """bin/apm decode without the chunk index, tpuzip.codecs.bin_apm.
    decode_batch: comp (B, CAP) u8 streams, CAP >= 1, lengths (B,) i32 in
    BYTES -> (B, out_n) u8, 0 past each length.  The read position runs on
    from byte 4, and a byte at or past CAP reads as the row's last byte, as
    tpuzip reads.

    A CPU tensor runs kernels.bin_coder.bin_decode_indexed_plain with no
    index; a CUDA tensor launches csrc/bin_decode.cu in its mode without
    the index, on the current stream (no synchronisation)."""
    from tpuzip_torch.kernels import bin_coder

    check_knobs(model_bits, rate)
    if comp.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError("decode_batch takes u8 streams and i32 lengths")
    if comp.dim() != 2 or lengths.shape != comp.shape[:1]:
        raise ValueError(f"shape mismatch: comp {tuple(comp.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if comp.shape[1] < 1 or out_n < 0:
        raise ValueError(f"decode_batch needs rows of at least 1 byte and "
                         f"out_n >= 0 (comp {tuple(comp.shape)}, out_n "
                         f"{out_n})")
    nc = -(-8 * out_n // bin_coder.CHUNK)
    # 8 * lengths, saturated (a row's bits past 8*out_n are never decoded)
    nbits = (lengths.to(torch.int64).clamp(0, out_n) * 8).to(torch.int32)
    if not bin_coder._check(comp, lengths):
        out = bin_coder.bin_decode_indexed_plain(comp, None, nbits,
                                                 model_bits, rate, use_apm,
                                                 nc=nc)
    else:
        out = bin_coder.launch_decode(comp, None, nbits, nc, model_bits,
                                      rate, use_apm)
        if out.numel():
            decode_batch.launches += 1
    return out[:, :out_n].contiguous()


decode_batch.launches = 0
