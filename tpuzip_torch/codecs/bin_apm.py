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
