"""DEFLATE (RFC 1951) — pure-Python reference decoder: a copy of the
parts of tpuzip/oracle/deflate.py that the port reads (the length and
distance tables and their code lookups, the bit reader, the canonical
Huffman decoder, ``decompress`` / ``decompress_ex``, ``package_merge``
and ``canonical_codes``).  The oracle's own encoder is not the deflate
codec's format contract: tpuzip's ``compress`` writes the bytes of its
C++ ``tpz_deflate``, and kernels/deflate_coder.py writes those; its
``package_merge`` orders the code lengths of tpuzip's device rule
(``deflate`` / ``deflate_batch``, codecs/deflate.py).

Decoder parity: rust-compress ``src/flate.rs`` (bit reader, canonical
Huffman table build, stored/fixed/dynamic block decode, 32 KiB LZ77
window); validated against streams produced by ``zlib.compress`` at all
levels.
"""

from __future__ import annotations

# Order in which code-length-code lengths are stored in a dynamic header.
CLCL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]

# Length codes 257..285: (extra bits, base length)
LENGTH_TABLE = [
    (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 9), (0, 10),
    (1, 11), (1, 13), (1, 15), (1, 17), (2, 19), (2, 23), (2, 27), (2, 31),
    (3, 35), (3, 43), (3, 51), (3, 59), (4, 67), (4, 83), (4, 99), (4, 115),
    (5, 131), (5, 163), (5, 195), (5, 227), (0, 258),
]
# Distance codes 0..29: (extra bits, base distance)
DIST_TABLE = [
    (0, 1), (0, 2), (0, 3), (0, 4), (1, 5), (1, 7), (2, 9), (2, 13),
    (3, 17), (3, 25), (4, 33), (4, 49), (5, 65), (5, 97), (6, 129), (6, 193),
    (7, 257), (7, 385), (8, 513), (8, 769), (9, 1025), (9, 1537),
    (10, 2049), (10, 3073), (11, 4097), (11, 6145), (12, 8193), (12, 12289),
    (13, 16385), (13, 24577),
]

MAX_BITS = 15
MAX_CL_BITS = 7
WINDOW = 32768
MIN_MATCH = 3
MAX_MATCH = 258


def length_to_code(length: int) -> tuple[int, int, int]:
    """length (3..258) -> (symbol 257..285, extra-bit count, extra-bit value)."""
    for i in range(len(LENGTH_TABLE) - 1, -1, -1):
        eb, base = LENGTH_TABLE[i]
        if length >= base and (i == 28 or length < LENGTH_TABLE[i + 1][1]):
            if i == 28 and length != 258:
                continue
            return 257 + i, eb, length - base
    raise ValueError(f"bad length {length}")


def dist_to_code(dist: int) -> tuple[int, int, int]:
    """distance (1..32768) -> (symbol 0..29, extra-bit count, extra-bit value)."""
    for i in range(len(DIST_TABLE) - 1, -1, -1):
        eb, base = DIST_TABLE[i]
        if dist >= base:
            return i, eb, dist - base
    raise ValueError(f"bad distance {dist}")


# ---------------------------------------------------------------------------
# Bit IO (LSB-first, per RFC 1951 §3.1.1)
# ---------------------------------------------------------------------------

class BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0       # byte position
        self.bitbuf = 0
        self.bitcnt = 0

    def bits(self, n: int) -> int:
        while self.bitcnt < n:
            if self.pos >= len(self.data):
                raise ValueError("truncated DEFLATE stream")
            self.bitbuf |= self.data[self.pos] << self.bitcnt
            self.pos += 1
            self.bitcnt += 8
        val = self.bitbuf & ((1 << n) - 1)
        self.bitbuf >>= n
        self.bitcnt -= n
        return val

    def align_byte(self) -> None:
        self.bitbuf = 0
        self.bitcnt = 0

    def bytes_consumed(self) -> int:
        return self.pos - (self.bitcnt // 8)


# ---------------------------------------------------------------------------
# Canonical Huffman (decode side): count/first-code tables, puff-style
# ---------------------------------------------------------------------------

class HuffmanDecoder:
    def __init__(self, lengths: list[int]) -> None:
        self.count = [0] * (MAX_BITS + 1)
        for l in lengths:
            if l:
                self.count[l] += 1
        # validate: over-subscribed / incomplete sets are format errors
        # (single-code "incomplete" sets are tolerated like zlib does for dists)
        left = 1
        for l in range(1, MAX_BITS + 1):
            left <<= 1
            left -= self.count[l]
            if left < 0:
                raise ValueError("over-subscribed Huffman code set")
        self.incomplete = left > 0
        # symbols sorted by (length, symbol) — canonical order
        offs = [0] * (MAX_BITS + 2)
        for l in range(1, MAX_BITS + 1):
            offs[l + 1] = offs[l] + self.count[l]
        self.symbols = [0] * offs[MAX_BITS + 1]
        for sym, l in enumerate(lengths):
            if l:
                self.symbols[offs[l]] = sym
                offs[l] += 1

    def decode(self, br: BitReader) -> int:
        code = 0
        first = 0
        index = 0
        for l in range(1, MAX_BITS + 1):
            code |= br.bits(1)
            cnt = self.count[l]
            if code - first < cnt:
                return self.symbols[index + (code - first)]
            index += cnt
            first = (first + cnt) << 1
            code <<= 1
        raise ValueError("invalid Huffman code")


def fixed_lit_lengths() -> list[int]:
    return [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8


def fixed_dist_lengths() -> list[int]:
    return [5] * 30


# ---------------------------------------------------------------------------
# Inflate
# ---------------------------------------------------------------------------

def decompress(data: bytes) -> bytes:
    out, _ = decompress_ex(data)
    return out


def decompress_ex(data: bytes) -> tuple[bytes, int]:
    """Inflate; returns (output, compressed bytes consumed)."""
    br = BitReader(data)
    out = bytearray()
    while True:
        final = br.bits(1)
        btype = br.bits(2)
        if btype == 0:  # stored
            br.align_byte()
            if br.pos + 4 > len(data):
                raise ValueError("truncated stored block header")
            ln = data[br.pos] | (data[br.pos + 1] << 8)
            nln = data[br.pos + 2] | (data[br.pos + 3] << 8)
            if ln != (~nln & 0xFFFF):
                raise ValueError("stored block LEN/NLEN mismatch")
            br.pos += 4
            out += data[br.pos : br.pos + ln]
            br.pos += ln
        elif btype in (1, 2):
            if btype == 1:
                lit = HuffmanDecoder(fixed_lit_lengths())
                dist = HuffmanDecoder(fixed_dist_lengths())
            else:
                lit, dist = _read_dynamic_header(br)
            _inflate_block(br, lit, dist, out)
        else:
            raise ValueError("reserved DEFLATE block type 3")
        if final:
            break
    return bytes(out), br.bytes_consumed()


def _read_dynamic_header(br: BitReader) -> tuple[HuffmanDecoder, HuffmanDecoder]:
    hlit = br.bits(5) + 257
    hdist = br.bits(5) + 1
    hclen = br.bits(4) + 4
    cl_lengths = [0] * 19
    for i in range(hclen):
        cl_lengths[CLCL_ORDER[i]] = br.bits(3)
    cl = HuffmanDecoder(cl_lengths)
    lengths: list[int] = []
    while len(lengths) < hlit + hdist:
        sym = cl.decode(br)
        if sym < 16:
            lengths.append(sym)
        elif sym == 16:
            if not lengths:
                raise ValueError("repeat code with no previous length")
            lengths += [lengths[-1]] * (3 + br.bits(2))
        elif sym == 17:
            lengths += [0] * (3 + br.bits(3))
        else:
            lengths += [0] * (11 + br.bits(7))
    if len(lengths) != hlit + hdist:
        raise ValueError("code length overflow in dynamic header")
    return HuffmanDecoder(lengths[:hlit]), HuffmanDecoder(lengths[hlit:])


def _inflate_block(br: BitReader, lit: HuffmanDecoder, dist: HuffmanDecoder,
                   out: bytearray) -> None:
    while True:
        sym = lit.decode(br)
        if sym < 256:
            out.append(sym)
        elif sym == 256:
            return
        else:
            if sym > 285:
                raise ValueError("bad length symbol")
            eb, base = LENGTH_TABLE[sym - 257]
            length = base + (br.bits(eb) if eb else 0)
            dsym = dist.decode(br)
            if dsym > 29:
                raise ValueError("bad distance symbol")
            deb, dbase = DIST_TABLE[dsym]
            d = dbase + (br.bits(deb) if deb else 0)
            if d > len(out):
                raise ValueError("distance beyond output start")
            start = len(out) - d
            for k in range(length):
                out.append(out[start + k])



# ---------------------------------------------------------------------------
# Length-limited Huffman (package-merge) — encode side
# ---------------------------------------------------------------------------

def package_merge(freqs: dict[int, int], limit: int) -> dict[int, int]:
    """Optimal length-limited code lengths via package-merge: each level
    sorted by (weight, symbol tuple), so ties fall in one total order
    (tpuzip's device deflate rule; its C++ rule sorts by weight alone,
    kernels/deflate_coder.package_merge)."""
    leaves = sorted((f, (s,)) for s, f in freqs.items() if f > 0)
    n = len(leaves)
    if n == 0:
        return {}
    if n == 1:
        return {leaves[0][1][0]: 1}
    if n > (1 << limit):
        raise ValueError("alphabet too large for length limit")
    current: list[tuple[int, tuple[int, ...]]] = list(leaves)
    for _ in range(limit - 1):
        packaged = [
            (current[i][0] + current[i + 1][0], current[i][1] + current[i + 1][1])
            for i in range(0, len(current) - 1, 2)
        ]
        current = sorted(leaves + packaged)
    lengths: dict[int, int] = {s: 0 for _, (s,) in leaves}
    for _, syms in current[: 2 * n - 2]:
        for s in syms:
            lengths[s] += 1
    return lengths


def canonical_codes(lengths: list[int]) -> list[int]:
    """RFC 1951 §3.2.2 canonical code assignment from code lengths."""
    max_len = max(lengths) if lengths else 0
    bl_count = [0] * (max_len + 1)
    for l in lengths:
        if l:
            bl_count[l] += 1
    code = 0
    next_code = [0] * (max_len + 2)
    for b in range(1, max_len + 1):
        code = (code + bl_count[b - 1]) << 1
        next_code[b] = code
    codes = [0] * len(lengths)
    for sym, l in enumerate(lengths):
        if l:
            codes[sym] = next_code[l]
            next_code[l] += 1
    return codes

