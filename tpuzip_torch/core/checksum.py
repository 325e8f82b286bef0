"""Per-block Adler-32 on tensors (container flag bit 1), and the streaming
Adler-32 and xxHash32 of the adapters (io.py).

Port of tpuzip/core/checksum.py:42-69.  The JAX version keeps every
partial sum below 2^32 with chunked mod-trees, because it works in u32.
Torch has int64 on every device, so the closed form is summed directly:

    s1 = 1 + sum(d_i)                 s2 = L + sum((L - i) * d_i)

over the first L bytes (0-based i), both mod 65521.  The weighted sum is
below 255 * L^2 / 2, well inside int64 for any block size the container
allows.  Validated against zlib.adler32.
"""

from __future__ import annotations

import zlib

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


# ---------------------------------------------------------------------------
# Streaming checksums of the adapters (io.py): the digests of tpuzip's
# AdlerStream and Xxh32Stream (tpuzip/core/checksum.py:81-128).
# ---------------------------------------------------------------------------


class AdlerStream:
    """Streaming Adler-32 (feed/result), zlib.adler32 on the host as in
    tpuzip."""

    def __init__(self) -> None:
        self.value = 1

    def feed(self, data) -> None:
        self.value = zlib.adler32(bytes(data), self.value)

    def result(self) -> int:
        return self.value


class Xxh32Stream:
    """Streaming xxHash32 with oracle.xxh32.Xxh32State's digest.  update
    takes bytes or a 1-D u8 tensor on `device`: its whole 16-byte stripes
    (after the bytes held from the last call) go through
    kernels/xxh32.xxh32_stripes, the four lane states carried on the
    device from call to call; the tail of fewer than 16 bytes, the length
    and the digest stay on the host."""

    def __init__(self, seed: int = 0, device="cuda") -> None:
        from tpuzip_torch.device import resolve
        from tpuzip_torch.oracle.xxh32 import Xxh32State

        self.dev = resolve(device)
        self.seed = seed
        lanes = Xxh32State(seed).v
        self.state = torch.tensor([v - (1 << 32) if v >> 31 else v
                                   for v in lanes], dtype=torch.int32,
                                  device=self.dev)
        self.tail = b""
        self.total = 0

    def update(self, data) -> None:
        from tpuzip_torch.kernels import xxh32

        if torch.is_tensor(data):
            if data.dtype != torch.uint8 or data.device != self.state.device:
                raise ValueError(f"Xxh32Stream on {self.dev} takes u8 "
                                 f"tensors there, got {data.dtype} on "
                                 f"{data.device}")
            flat = data.reshape(-1)
            n = flat.numel()
            if len(self.tail) + n < 16:
                self.tail += flat.cpu().numpy().tobytes()
                self.total += n
                return
            if self.tail:
                head = torch.frombuffer(bytearray(self.tail),
                                        dtype=torch.uint8).to(self.dev)
                flat = torch.cat([head, flat])
        else:
            data = bytes(data)
            n = len(data)
            if len(self.tail) + n < 16:
                self.tail += data
                self.total += n
                return
            flat = torch.frombuffer(bytearray(self.tail + data),
                                    dtype=torch.uint8).to(self.dev)
        self.total += n
        stripes = flat.numel() // 16
        flat = flat.contiguous()
        xxh32.xxh32_stripes(self.state, flat, stripes)
        self.tail = flat[16 * stripes :].cpu().numpy().tobytes()

    def digest(self) -> int:
        from tpuzip_torch.oracle.xxh32 import Xxh32State

        st = Xxh32State(self.seed)
        st.v = [v & 0xFFFFFFFF for v in self.state.tolist()]
        st.tail, st.total = self.tail, self.total
        return st.digest()
