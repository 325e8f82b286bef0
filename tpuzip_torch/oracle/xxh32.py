"""xxHash32 -- the LZ4 frame format's checksums (the header's HC byte, the
content checksum and the optional block checksums): a copy of
tpuzip/oracle/xxh32.py (``xxh32``, ``Xxh32State``).  Public-domain
algorithm by Yann Collet.
"""

from __future__ import annotations

P1 = 2654435761
P2 = 2246822519
P3 = 3266489917
P4 = 668265263
P5 = 374761393
M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    x &= M32
    return ((x << r) | (x >> (32 - r))) & M32


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & M32
        v2 = (seed + P2) & M32
        v3 = seed & M32
        v4 = (seed - P1) & M32
        while i <= n - 16:
            lane = [int.from_bytes(data[i + 4 * k : i + 4 * k + 4], "little") for k in range(4)]
            v1 = (_rotl(v1 + lane[0] * P2, 13) * P1) & M32
            v2 = (_rotl(v2 + lane[1] * P2, 13) * P1) & M32
            v3 = (_rotl(v3 + lane[2] * P2, 13) * P1) & M32
            v4 = (_rotl(v4 + lane[3] * P2, 13) * P1) & M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & M32
    else:
        h = (seed + P5) & M32
    h = (h + n) & M32
    while i <= n - 4:
        h = (_rotl(h + int.from_bytes(data[i : i + 4], "little") * P3, 17) * P4) & M32
        i += 4
    while i < n:
        h = (_rotl(h + data[i] * P5, 11) * P1) & M32
        i += 1
    h ^= h >> 15
    h = (h * P2) & M32
    h ^= h >> 13
    h = (h * P3) & M32
    h ^= h >> 16
    return h


class Xxh32State:
    """Incremental xxHash32 (for streaming frame writers)."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.v = [(seed + P1 + P2) & M32, (seed + P2) & M32, seed & M32,
                  (seed - P1) & M32]
        self.tail = b""
        self.total = 0

    def update(self, data: bytes) -> None:
        self.total += len(data)
        buf = self.tail + data
        i = 0
        v1, v2, v3, v4 = self.v
        while i + 16 <= len(buf):
            lanes = [int.from_bytes(buf[i + 4 * k : i + 4 * k + 4], "little")
                     for k in range(4)]
            v1 = (_rotl(v1 + lanes[0] * P2, 13) * P1) & M32
            v2 = (_rotl(v2 + lanes[1] * P2, 13) * P1) & M32
            v3 = (_rotl(v3 + lanes[2] * P2, 13) * P1) & M32
            v4 = (_rotl(v4 + lanes[3] * P2, 13) * P1) & M32
            i += 16
        self.v = [v1, v2, v3, v4]
        self.tail = buf[i:]

    def digest(self) -> int:
        if self.total >= 16:
            h = (_rotl(self.v[0], 1) + _rotl(self.v[1], 7)
                 + _rotl(self.v[2], 12) + _rotl(self.v[3], 18)) & M32
        else:
            h = (self.seed + P5) & M32
        h = (h + self.total) & M32
        buf = self.tail
        i = 0
        while i + 4 <= len(buf):
            h = (_rotl(h + int.from_bytes(buf[i:i+4], "little") * P3, 17) * P4) & M32
            i += 4
        while i < len(buf):
            h = (_rotl(h + buf[i] * P5, 11) * P1) & M32
            i += 1
        h ^= h >> 15
        h = (h * P2) & M32
        h ^= h >> 13
        h = (h * P3) & M32
        h ^= h >> 16
        return h
