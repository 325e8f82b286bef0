"""csrc/inflate.cu's decode tables, replicated step for step: the root
table with subtables in a pool (a prefix whose subtable the pool cannot
hold decoded by the canonical walk over its lengths), the entry format
(code length, kind, base and extra bits), and what the kernel does with a
set that has no code or too many.  Every 15-bit window of random complete,
incomplete and 15-bit code-length sets decodes to the entry of the symbol
that kernels/deflate_coder.py's canonical table (``_huffman``) finds
there, and a window that table finds no code in to a code-less entry.
And the kernel's bytes from its tokens: batches of 32 built in a shared
history, their matches resolved in rounds.  The CUDA kernel itself is
held against the plain inflate on the card by chip_smoke.py."""

import zlib

import numpy as np
import pytest

from tpuzip.runtime import native
from tpuzip_torch.kernels import deflate_coder as dc
from tpuzip_torch.oracle.deflate import fixed_dist_lengths, fixed_lit_lengths

with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()

# csrc/inflate.cu's constants
LIT_ROOT, DIST_ROOT, LIT_POOL, DIST_POOL = 10, 8, 256, 128
K_LIT, K_BASE, K_END, K_BAD, K_SUB, K_WALK = range(6)
BAD_ENTRY = K_BAD << 4
T_CODES, T_LIT, T_DIST = range(3)


def _rev(v: int, k: int) -> int:
    return int(f"{v:0{k}b}"[::-1], 2) if k else 0


def entry_of(t: int, sym: int, ln: int) -> int:
    """inflate.cu's entry_of: value << 16 | extra << 8 | kind << 4 | len."""
    if t == T_CODES or (t == T_LIT and sym < 256):
        return sym << 16 | K_LIT << 4 | ln
    if t == T_LIT and sym == 256:
        return K_END << 4 | ln
    if t == T_LIT and sym < 286:
        return (dc.LEN_BASE[sym - 257] << 16 | dc.LEN_EXTRA[sym - 257] << 8
                | K_BASE << 4 | ln)
    if t == T_DIST and sym < 30:
        return (dc.DIST_BASE[sym] << 16 | dc.DIST_EXTRA[sym] << 8
                | K_BASE << 4 | ln)
    return K_BAD << 4 | ln


def build(lens: list, t: int, bits: int, pool_size: int):
    """inflate.cu's build: None for a set with no code or an
    oversubscribed one (its root all BAD_ENTRY); else the table."""
    n = len(lens)
    count = [0] * 16
    for ln in lens:
        count[ln] += 1
    left, code, at = 1, 0, 0
    first, offs = [0] * 16, [0] * 16
    over = False
    for ln in range(1, 16):
        left = 2 * left - count[ln]
        over |= left < 0
        first[ln], offs[ln] = code, at
        at += count[ln]
        code = (code + count[ln]) << 1
    if count[0] == n or over:
        return None
    ncodes = at
    order = sorted((ln, s) for s, ln in enumerate(lens) if ln)
    srt = [s for _, s in order]
    root = [BAD_ENTRY] * (1 << bits)
    pool = [BAD_ENTRY] * pool_size

    def code_of(k):
        ln = lens[srt[k]]
        return first[ln] + k - offs[ln], ln

    long_at = offs[bits + 1]
    for k in range(long_at):
        c, ln = code_of(k)
        for j in range(_rev(c, ln), 1 << bits, 1 << ln):
            root[j] = entry_of(t, srt[k], ln)
    # a subtable for each root prefix of longer codes, in code order, each
    # sized by its last (longest) code; one past the pool asks for the walk
    start = 0
    for k in range(long_at, ncodes):
        c, ln = code_of(k)
        p = c >> (ln - bits)
        if k + 1 < ncodes:
            c2, ln2 = code_of(k + 1)
            if c2 >> (ln2 - bits) == p:
                continue
        size = 1 << (ln - bits)
        root[_rev(p, bits)] = (start << 16 | (ln - bits) << 8 | K_SUB << 4
                               if start + size <= pool_size
                               else K_WALK << 4)
        start += size
    for k in range(long_at, ncodes):
        c, ln = code_of(k)
        r = root[_rev(c >> (ln - bits), bits)]
        if (r >> 4) & 7 != K_SUB:
            continue
        tail = ln - bits
        for j in range(_rev(c & ((1 << tail) - 1), tail), 1 << ((r >> 8) & 15),
                       1 << tail):
            pool[(r >> 16) + j] = entry_of(t, srt[k], ln)
    return dict(root=root, pool=pool, sorted=srt, count=count, offs=offs,
                first=first, bits=bits, type=t)


def lookup(tab: dict, buf: int) -> int:
    """inflate.cu's lookup: the entry of the code at bit 0 of buf."""
    bits = tab["bits"]
    e = tab["root"][buf & ((1 << bits) - 1)]
    kind = (e >> 4) & 7
    if kind == K_SUB:
        return tab["pool"][(e >> 16)
                           + ((buf >> bits) & ((1 << ((e >> 8) & 15)) - 1))]
    if kind == K_WALK:
        rev = _rev(buf & 0x7FFF, 15)
        for ln in range(bits + 1, 16):
            i = (rev >> (15 - ln)) - tab["first"][ln]
            if 0 <= i < tab["count"][ln]:
                return entry_of(tab["type"],
                                tab["sorted"][tab["offs"][ln] + i], ln)
        return BAD_ENTRY
    return e


def _decodes_as_canonical(lens: list, t: int, bits: int, pool: int):
    """Every 15-bit window decodes through the replica to the entry of the
    canonical table's symbol there (a code-less entry where it has none);
    -> the kinds of root entries the set took."""
    ref = dc._huffman(lens)
    tab = build(lens, t, bits, pool)
    if ref is None:
        assert tab is None
        return set()
    table, top = ref
    for buf in range(1 << 15):
        hit = table[buf & ((1 << top) - 1)]
        want = BAD_ENTRY if hit is None else entry_of(t, *hit)
        assert lookup(tab, buf) == want, (buf, hit)
    return {(e >> 4) & 7 for e in tab["root"]}


def _random_lengths(rng, n: int, complete: bool, top: int = 15):
    """A random set of n lengths: package-merge over skewed frequencies
    (complete), or random lengths cut to Kraft's sum (incomplete)."""
    if complete:
        freq = (rng.pareto(0.7, n) * 10).astype(int) * (rng.random(n) < 0.8)
        freq[rng.integers(0, n, 2)] += 1
        lens = dc.package_merge([int(f) for f in freq], top)
        return [int(v) for v in lens]
    lens = [int(v) for v in rng.integers(0, top + 1, n)]
    while sum(2.0 ** -ln for ln in lens if ln) > 1:
        lens[int(rng.integers(0, n))] = 0
    return lens


@pytest.mark.parametrize("t,n,bits,pool", [(T_LIT, 286, LIT_ROOT, LIT_POOL),
                                           (T_DIST, 30, DIST_ROOT, DIST_POOL)])
@pytest.mark.parametrize("complete", [True, False])
def test_random_sets_decode_as_canonical(t, n, bits, pool, complete):
    rng = np.random.default_rng(17 + n + complete)
    kinds = set()
    for _ in range(4):
        kinds |= _decodes_as_canonical(_random_lengths(rng, n, complete), t,
                                       bits, pool)
    assert K_SUB in kinds   # the sets reach past the root


def test_fifteen_bit_and_walked_sets():
    # a complete chain down to 15 bits: one prefix's subtable of 2^7
    chain = list(range(1, 16)) + [15]
    assert K_SUB in _decodes_as_canonical(chain + [0] * 14, T_DIST, DIST_ROOT,
                                          DIST_POOL)
    assert K_SUB in _decodes_as_canonical(chain + [0] * 270, T_LIT, LIT_ROOT,
                                          LIT_POOL)
    # 286 codes of 15 bits: nine prefixes of 32 entries, the ninth past the
    # pool of 256, so walked
    kinds = _decodes_as_canonical([15] * 286, T_LIT, LIT_ROOT, LIT_POOL)
    assert {K_SUB, K_WALK, K_BAD} <= kinds
    # 30 codes of 15 bits: one subtable of 128, the whole distance pool
    assert K_SUB in _decodes_as_canonical([15] * 30, T_DIST, DIST_ROOT,
                                          DIST_POOL)
    # a pool too small for any: every long prefix walked
    rng = np.random.default_rng(5)
    kinds = _decodes_as_canonical(_random_lengths(rng, 286, True), T_LIT,
                                  LIT_ROOT, 0)
    assert K_WALK in kinds and K_SUB not in kinds


def test_fixed_and_code_length_sets():
    assert _decodes_as_canonical(fixed_lit_lengths(), T_LIT, LIT_ROOT,
                                 LIT_POOL) <= {K_LIT, K_BASE, K_END, K_BAD}
    # fixed distances: 30 codes of 5 bits, codes 30 and 31 code-less
    assert K_BAD in _decodes_as_canonical(fixed_dist_lengths(), T_DIST,
                                          DIST_ROOT, DIST_POOL)
    rng = np.random.default_rng(9)
    for complete in (True, False):
        _decodes_as_canonical(_random_lengths(rng, 19, complete, 7), T_CODES,
                              DIST_ROOT, DIST_POOL)


def test_entry_fields():
    lit = build(fixed_lit_lengths(), T_LIT, LIT_ROOT, LIT_POOL)
    codes = dc._reversed_codes(fixed_lit_lengths())
    for sym, base, extra in ((0, 0, 0), (255, 255, 0), (257, 3, 0),
                             (265, 11, 1), (284, 227, 5), (285, 258, 0)):
        e = lookup(lit, codes[sym])
        assert e & 15 == fixed_lit_lengths()[sym]
        assert (e >> 16, (e >> 8) & 15) == (base, extra)
        assert (e >> 4) & 7 == (K_LIT if sym < 256 else K_BASE)
    assert (lookup(lit, codes[256]) >> 4) & 7 == K_END
    assert (lookup(lit, codes[286]) >> 4) & 7 == K_BAD
    dist = build(fixed_dist_lengths(), T_DIST, DIST_ROOT, DIST_POOL)
    dcodes = dc._reversed_codes(fixed_dist_lengths())
    e = lookup(dist, dcodes[29])
    assert (e >> 16, (e >> 8) & 15, (e >> 4) & 7, e & 15) == (24577, 13,
                                                               K_BASE, 5)


@pytest.mark.parametrize("lens", [[0] * 30, [0] * 286, [1, 1, 1] + [0] * 27,
                                  [2] * 5 + [0] * 281, [1, 1, 2] + [0] * 27])
def test_empty_and_oversubscribed_are_refused(lens):
    assert dc._huffman(lens) is None
    t, bits = (T_DIST, DIST_ROOT) if len(lens) == 30 else (T_LIT, LIT_ROOT)
    assert build(lens, t, bits, LIT_POOL) is None


HIST = 16384   # csrc/inflate.cu's shared history


def _tokens(stream: bytes) -> list:
    """The stream's tokens, in order, by the plain decoder's parts: a
    literal (1, byte), a match (length, distance), or a stored block
    ("stored", its bytes)."""
    rd = dc._Reader(stream)
    out = []
    while True:
        final, btype = rd.bits(1), rd.bits(2)
        if btype == 0:
            rd.pos = -(-rd.pos // 8) * 8
            at = rd.pos >> 3
            ln = stream[at] | stream[at + 1] << 8
            out.append(("stored", stream[at + 4 : at + 4 + ln]))
            rd.pos = 8 * (at + 4 + ln)
        else:
            lit, dist = ((dc._huffman(fixed_lit_lengths()),
                          dc._huffman(fixed_dist_lengths()))
                         if btype == 1 else dc._dynamic_header(rd))
            while (s := dc._decode(rd, lit)) != 256:
                if s < 256:
                    out.append((1, s))
                    continue
                ln = dc.LEN_BASE[s - 257] + rd.bits(dc.LEN_EXTRA[s - 257])
                ds = dc._decode(rd, dist)
                out.append((ln, dc.DIST_BASE[ds] + rd.bits(dc.DIST_EXTRA[ds])))
        if final:
            return out


def _expand_in_batches(tokens: list):
    """csrc/inflate.cu's bytes from its tokens: batches of up to 32 tokens
    built in a history of the last HIST bytes (byte p at p % HIST), each
    batch's literals first, then its matches in rounds (a match is ready
    when its source's end lies at or before the earliest pending match's
    start; its source bytes from the history where they lie past its
    lower bound, else from the output), then the batch flushed; a stored
    block goes straight to the output, and the history below its end is
    stale.  -> (bytes, batches, rounds)."""
    out, hist = bytearray(), bytearray(HIST)
    hist_lo, batches, rounds, k = 0, 0, 0, 0
    while k < len(tokens):
        if tokens[k][0] == "stored":
            out += tokens[k][1]
            hist_lo = len(out)
            k += 1
            continue
        batch = []
        while k < len(tokens) and len(batch) < 32 and tokens[k][0] != "stored":
            batch.append(tokens[k])
            k += 1
        o0, at = len(out), len(out)
        places = []
        for ln, v in batch:
            places.append(at)
            if ln == 1:
                hist[at % HIST] = v
            at += ln
        end = at
        lo = max(hist_lo, end - HIST)

        def get(p):
            return hist[p % HIST] if p >= lo else out[p]

        pending = [j for j, (ln, _) in enumerate(batch) if ln > 1]
        while pending:
            rounds += 1
            first = min(places[j] for j in pending)
            ready = [j for j in pending
                     if places[j] - batch[j][1] + min(batch[j]) <= first]
            for j in ready:   # loads before stores, as a warp's round
                ln, d = batch[j]
                src = [get(places[j] - d + m % d) for m in range(ln)]
                for m, v in enumerate(src):
                    hist[(places[j] + m) % HIST] = v
            pending = [j for j in pending if j not in ready]
        out += bytes(hist[p % HIST] for p in range(o0, end))
        batches += 1
    return bytes(out), batches, rounds


def test_batches_build_the_bytes():
    """Decoding the symbols apart from the bytes they produce, as the
    kernel does, gives zlib's bytes: text at max_chain 128 (matches inside
    a batch reading each other), a row of codes of 12-15 bits whose
    distances reach 32,768 (sources past the history), runs (a match
    reading its own bytes), and zlib streams with stored blocks between
    Huffman blocks."""
    rng = np.random.default_rng(3)
    far = rng.integers(0, 256, 40000, np.uint8)
    far[33000:33300] = far[33000 - 32768 : 33300 - 32768]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    mixed = (co.compress(TEXT[:7000]) + co.flush(zlib.Z_FULL_FLUSH)
             + co.compress(rng.integers(0, 256, 3000, np.uint8).tobytes())
             + co.flush(zlib.Z_SYNC_FLUSH) + co.compress(TEXT[:5000])
             + co.flush())
    streams = [native.deflate(TEXT[:20000], 128, "dynamic"),
               native.deflate(far.tobytes(), 128, "dynamic"),
               native.deflate(bytes(5000) + b"ab" * 3000, 8, "fixed"),
               mixed]
    total = 0
    for s in streams:
        got, batches, rounds = _expand_in_batches(_tokens(s))
        assert got == zlib.decompress(s, -15)
        total += rounds
    assert total > len(streams)   # some batches took several rounds
