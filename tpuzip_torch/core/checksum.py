"""Per-block Adler-32 on tensors (container flag bit 1).

Port of tpuzip/core/checksum.py:42-69.  The JAX version keeps every
partial sum below 2^32 with chunked mod-trees, because it works in u32.
Torch has int64 on every device, so the closed form is summed directly:

    s1 = 1 + sum(d_i)                 s2 = L + sum((L - i) * d_i)

over the first L bytes (0-based i), both mod 65521.  The weighted sum is
below 255 * L^2 / 2, well inside int64 for any block size the container
allows.  Validated against zlib.adler32.
"""

from __future__ import annotations

import torch

MOD = 65521
ROWS = 64   # blocks summed at once, to bound the int64 temporaries


def adler32_batch(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, N) u8 + (B,) lengths -> (B,) int64 holding each block's u32
    Adler-32 of ``block[:length]``."""
    b, n = blocks.shape
    lens = lengths.to(torch.int64)
    out = torch.empty(b, dtype=torch.int64, device=blocks.device)
    iota = torch.arange(n, dtype=torch.int64, device=blocks.device)
    for g in range(0, b, ROWS):
        d = blocks[g : g + ROWS].to(torch.int64)
        ln = lens[g : g + ROWS]
        weight = (ln[:, None] - iota[None, :]).clamp(min=0)   # 0 past L
        s1 = (1 + (d * (weight > 0)).sum(dim=1)) % MOD
        s2 = (ln + (d * weight).sum(dim=1)) % MOD
        out[g : g + ROWS] = (s2 << 16) | s1
    return out
