"""Adaptive arithmetic ("ari") coding oracle: a copy of the range coder
core, the table model, the bin/APM bit models and the order-0 byte coder
of tpuzip/oracle/ari.py.

The coder is a Subbotin-style carryless 32-bit range coder:
renormalization emits the top byte whenever the top byte of ``low`` is
settled, and forces range down at the BOT boundary instead of propagating
carries, so every symbol emits at most ``MAX_RENORM`` bytes.

Invariants: ``range >= BOT`` between symbols; model totals must be ``<= BOT``.
"""

from __future__ import annotations

TOP = 1 << 24
BOT = 1 << 16
MASK = 0xFFFFFFFF
MAX_RENORM = 4  # max bytes emitted per encoded symbol (asserted below)


class RangeEncoder:
    def __init__(self) -> None:
        self.low = 0
        self.range = MASK
        self.out = bytearray()

    def encode(self, cum_lo: int, cum_hi: int, total: int) -> None:
        assert 0 <= cum_lo < cum_hi <= total <= BOT
        r = self.range // total
        self.low = (self.low + r * cum_lo) & MASK
        self.range = r * (cum_hi - cum_lo)
        self._normalize()

    def _normalize(self) -> None:
        emitted = 0
        while True:
            if (self.low ^ (self.low + self.range)) & MASK < TOP:
                pass  # top byte settled — emit it
            elif self.range < BOT:
                # carryless trick: shrink range to the BOT boundary
                self.range = (-self.low) & (BOT - 1)
            else:
                break
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & MASK
            self.range = (self.range << 8) & MASK
            emitted += 1
        assert emitted <= MAX_RENORM

    def finish(self) -> bytes:
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & MASK
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.low = 0
        self.range = MASK
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._next_byte()) & MASK

    def _next_byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode_offset(self, total: int) -> int:
        """Return the cumulative-frequency offset of the next symbol."""
        r = self.range // total
        v = ((self.code - self.low) & MASK) // r
        return min(v, total - 1)

    def decode_update(self, cum_lo: int, cum_hi: int, total: int) -> None:
        r = self.range // total
        self.low = (self.low + r * cum_lo) & MASK
        self.range = r * (cum_hi - cum_lo)
        while True:
            if (self.low ^ (self.low + self.range)) & MASK < TOP:
                pass
            elif self.range < BOT:
                self.range = (-self.low) & (BOT - 1)
            else:
                break
            self.code = ((self.code << 8) | self._next_byte()) & MASK
            self.low = (self.low << 8) & MASK
            self.range = (self.range << 8) & MASK


class TableModel:
    """Adaptive cumulative-frequency model over ``num_symbols`` symbols.

    ``update(sym)`` adds ``increment`` to the symbol's frequency and halves
    all frequencies (keeping them >= 1) when the total crosses ``threshold``.
    """

    def __init__(self, num_symbols: int, increment: int = 8,
                 threshold: int = 1 << 13) -> None:
        assert threshold <= BOT
        self.freq = [1] * num_symbols
        self.total = num_symbols
        self.increment = increment
        self.threshold = threshold

    def get_range(self, sym: int) -> tuple[int, int]:
        lo = sum(self.freq[:sym])
        return lo, lo + self.freq[sym]

    def find_value(self, offset: int) -> tuple[int, int, int]:
        """offset -> (symbol, cum_lo, cum_hi)."""
        acc = 0
        for s, f in enumerate(self.freq):
            if offset < acc + f:
                return s, acc, acc + f
            acc += f
        raise ValueError("offset out of range")

    def get_denominator(self) -> int:
        return self.total

    def update(self, sym: int) -> None:
        self.freq[sym] += self.increment
        self.total += self.increment
        if self.total >= self.threshold:
            total = 0
            for i, f in enumerate(self.freq):
                self.freq[i] = (f + 1) >> 1
                total += self.freq[i]
            self.total = total


class BinaryModel:
    """Single-bit adaptive model with shift-based update (bin.rs parity)."""

    def __init__(self, bits: int = 12, rate: int = 5) -> None:
        self.bits = bits
        self.rate = rate
        self.p0 = 1 << (bits - 1)  # probability of bit 0, scaled by 2^bits

    def get_range(self, bit: int) -> tuple[int, int]:
        if bit == 0:
            return 0, self.p0
        return self.p0, 1 << self.bits

    def get_denominator(self) -> int:
        return 1 << self.bits

    def find_value(self, offset: int) -> tuple[int, int, int]:
        bit = 0 if offset < self.p0 else 1
        lo, hi = self.get_range(bit)
        return bit, lo, hi

    def update(self, bit: int) -> None:
        if bit == 0:
            self.p0 += ((1 << self.bits) - self.p0) >> self.rate
        else:
            self.p0 -= self.p0 >> self.rate
        self.p0 = min(max(self.p0, 1), (1 << self.bits) - 1)


class ApmBit:
    """A probability cell: predict()/update(bit, rate) (apm.rs Bit parity)."""

    BITS = 12

    def __init__(self, p0: int | None = None) -> None:
        self.p0 = (1 << (self.BITS - 1)) if p0 is None else p0

    def predict(self) -> int:
        return self.p0

    def update(self, bit: int, rate: int) -> None:
        if bit == 0:
            self.p0 += ((1 << self.BITS) - self.p0) >> rate
        else:
            self.p0 -= self.p0 >> rate
        self.p0 = min(max(self.p0, 1), (1 << self.BITS) - 1)


class ApmGate:
    """Secondary symbol estimation: refine an input probability through a
    table of ApmBit cells indexed by quantized probability (apm.rs Gate)."""

    SLOTS = 33

    def __init__(self) -> None:
        self.cells = [
            ApmBit(max(1, min((1 << ApmBit.BITS) - 1,
                              (i * (1 << ApmBit.BITS)) // (self.SLOTS - 1))))
            for i in range(self.SLOTS)
        ]
        self._last = 0

    def pass_through(self, p0: int) -> int:
        """Map a 12-bit p0 through the SSE table with linear interpolation."""
        scaled = p0 * (self.SLOTS - 1)
        idx = scaled >> ApmBit.BITS
        frac = scaled & ((1 << ApmBit.BITS) - 1)
        idx = min(idx, self.SLOTS - 2)
        self._last = idx if frac < (1 << (ApmBit.BITS - 1)) else idx + 1
        a = self.cells[idx].predict()
        b = self.cells[idx + 1].predict()
        p = (a * ((1 << ApmBit.BITS) - frac) + b * frac) >> ApmBit.BITS
        return min(max(p, 1), (1 << ApmBit.BITS) - 1)

    def update(self, bit: int, rate: int) -> None:
        self.cells[self._last].update(bit, rate)


def encode_bytes(data: bytes, increment: int = 8,
                 threshold: int = 1 << 13) -> bytes:
    model = TableModel(256, increment, threshold)
    enc = RangeEncoder()
    for b in data:
        lo, hi = model.get_range(b)
        enc.encode(lo, hi, model.get_denominator())
        model.update(b)
    return enc.finish()


def decode_bytes(comp: bytes, num_bytes: int, increment: int = 8,
                 threshold: int = 1 << 13) -> bytes:
    model = TableModel(256, increment, threshold)
    dec = RangeDecoder(comp)
    out = bytearray()
    for _ in range(num_bytes):
        offset = dec.decode_offset(model.get_denominator())
        sym, lo, hi = model.find_value(offset)
        dec.decode_update(lo, hi, model.get_denominator())
        model.update(sym)
        out.append(sym)
    return bytes(out)
