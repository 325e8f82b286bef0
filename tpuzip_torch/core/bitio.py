"""Parallel byte packing by prefix sums: the varint packer of
tpuzip/core/bitio.py, batched over rows, on the tensor's device.

Every serial "append to the output stream" loop becomes per-token sizes ->
exclusive cumsum -> one scatter into a fixed-capacity buffer; bytes that
fall at or past the capacity are dropped.  tpuzip's sort variant
``pack_bytes_varlen_sorted`` (which its DC encoder calls) existed because
scatter was slow on the TPU; it computes the same function, so the port
has only the scatter, ``pack_bytes_varlen``.
tpuzip's bit packers (``bit_reverse``, ``pack_bits_lsb``,
``unpack_bits_lsb``) serve its XLA deflate encoder alone; the port writes
that rule's bits with the C++ rule's emit (kernels/deflate_coder.py), so
it has none of them.
"""

from __future__ import annotations

import torch


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Along the last dimension: [0, x0, x0+x1, ...] without the total."""
    c = torch.cumsum(x, dim=-1)
    return c - x


def pack_bytes_varlen(chunks: torch.Tensor, lens: torch.Tensor,
                      cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate the variable-length byte chunks of every row.

    chunks (B, T, K) u8, row b's chunk t occupying chunks[b, t, :lens[b, t]];
    lens (B, T) -> (out (B, cap) u8, zero past each row's bytes, total (B,)
    int64, which may exceed cap: the bytes past cap are dropped)."""
    b, t, k = chunks.shape
    lens = lens.to(torch.int64)
    offs = exclusive_cumsum(lens)
    col = torch.arange(k, device=chunks.device)
    pos = offs[:, :, None] + col
    pos = torch.where((col < lens[:, :, None]) & (pos < cap), pos, cap)
    out = torch.zeros((b, cap + 1), dtype=torch.uint8, device=chunks.device)
    # every kept position is written once; the dropped all land in column cap
    out.scatter_(1, pos.reshape(b, t * k), chunks.reshape(b, t * k))
    return out[:, :cap], lens.sum(dim=1)
