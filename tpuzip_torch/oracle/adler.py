"""Adler-32 checksum (RFC 1950 §8.2): a copy of tpuzip/oracle/adler.py.

Reference parity: rust-compress ``src/checksum/adler.rs`` (State32 with
s1/s2 accumulators mod 65521, NMAX-batched reduction).  Validated against
``zlib.adler32``.
"""

from __future__ import annotations

import numpy as np

MOD = 65521
# Largest n such that 255*n*(n+1)/2 + (n+1)*(MOD-1) fits in u32 — lets us defer
# the modulo reduction across a batch of bytes (same trick as zlib's NMAX).
NMAX = 5552


class State32:
    """Incremental Adler-32, mirroring the reference's feed()/result() API."""

    def __init__(self) -> None:
        self.s1 = 1
        self.s2 = 0

    def feed(self, data: bytes | np.ndarray) -> None:
        arr = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.uint64)
        s1, s2 = self.s1, self.s2
        for ofs in range(0, len(arr), NMAX):
            chunk = arr[ofs : ofs + NMAX]
            # s2 accumulates a weighted sum: s2 += n*s1_in + sum((n-i)*c_i)
            n = len(chunk)
            csum = int(chunk.sum())
            wsum = int((chunk * np.arange(n, 0, -1, dtype=np.uint64)).sum())
            s2 = (s2 + n * s1 + wsum) % MOD
            s1 = (s1 + csum) % MOD
        self.s1, self.s2 = s1, s2

    def result(self) -> int:
        return (self.s2 << 16) | self.s1


def adler32(data: bytes, start: int = 1) -> int:
    st = State32()
    st.s1 = start & 0xFFFF
    st.s2 = (start >> 16) & 0xFFFF
    st.feed(data)
    return st.result()


def combine(a1: int, a2: int, len2: int) -> int:
    """Adler-32 of the concatenation from the two parts' checksums
    (zlib's adler32_combine): the second part's s1/s2 advance the first
    by len2 bytes of known running sums."""
    rem = len2 % MOD
    s1_1, s2_1 = a1 & 0xFFFF, (a1 >> 16) & 0xFFFF
    s1_2, s2_2 = a2 & 0xFFFF, (a2 >> 16) & 0xFFFF
    s1 = (s1_1 + s1_2 + MOD - 1) % MOD
    s2 = (s2_1 + s2_2 + rem * (s1_1 + MOD - 1)) % MOD
    return (s2 << 16) | s1
