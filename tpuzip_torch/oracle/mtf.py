"""Move-to-front oracle: a copy of tpuzip/oracle/mtf.py.

Encode maps a symbol to its rank in a recency list and moves it to the
front; decode is the mirror.
"""

from __future__ import annotations


class MTF:
    def __init__(self) -> None:
        self.symbols = list(range(256))

    def encode_sym(self, sym: int) -> int:
        rank = self.symbols.index(sym)
        if rank:
            del self.symbols[rank]
            self.symbols.insert(0, sym)
        return rank

    def decode_sym(self, rank: int) -> int:
        sym = self.symbols[rank]
        if rank:
            del self.symbols[rank]
            self.symbols.insert(0, sym)
        return sym


def encode(data: bytes) -> bytes:
    m = MTF()
    return bytes(m.encode_sym(b) for b in data)


def decode(data: bytes) -> bytes:
    m = MTF()
    return bytes(m.decode_sym(b) for b in data)
