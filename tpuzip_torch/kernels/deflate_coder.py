"""The deflate codec's encoder and inflate over a batch of blocks: the CUDA
kernels' wrappers and their plain PyTorch versions.

Off the TPU tpuzip's runner encodes codec "deflate" with its C++
``tpz_deflate`` (csrc/tpuzip_host.cpp:1314-1583, through
``native.deflate_batch_native``) and decodes it with ``tpz_inflate``
(:1020-1111, through ``native.inflate_batch_native``); tpuzip has no
Pallas form of either.  The port may not call them, so
csrc/deflate_encode.cu and csrc/inflate.cu replace them, and the
functions here are theirs:

  links  prev[p] for every position p with p + 2 < length: the last
         q < p whose 3 bytes hash as p's, h = (v * 2654435761 mod 2^32)
         >> 17 (15 bits); -1 where there is none and from length - 2 on.
         The C++ inserts every position into its chain once, before its
         parse reaches it (the lazy step inserts i before it probes
         i + 1), so when it probes p the chain is prev's.  Rows of at
         most 65,536 bytes take the shared route, wider ones the tiled
         route (links_route); both give the same prev.
  parse  best(p): the longest match over the first max_chain links of
         p's chain that lie at most 32,768 back, extended to at most
         min(258, length - p) bytes, the first link on ties; 0 from
         length - 2 on.  At i: best(i) under 3 makes i a literal; else
         the match is deferred while i + 4 <= length and best(i + 1) >
         best(i) (i becomes a literal), then emitted, and the parse goes on
         at its end.  Tokens, one an i32: a literal is its byte, a match
         length << 16 | distance.
  emit   the block from the tokens.  Dynamic (mode 0): histograms (EOB
         counted once), package-merge code lengths for literals/lengths
         (286 symbols, 15 bits) and distances (30, 15), the degenerate
         tables fixed as the C++ fixes them, canonical codes, hlit/hdist
         trimmed, the lengths run-length coded with 16/17/18, their code
         (19 symbols, 7 bits) by package-merge too, hclen trimmed; then
         the header, the tokens and EOB.  Fixed (mode 1): the RFC's codes.
         Stored (mode 2, no tokens): blocks of at most 65,535 bytes.
         Every stream is one final block but stored ones; comp is zero past
         each stream.  The fragment mode (deflate_emit_fragment, tpuzip's
         tpz_deflate_fragment, the batches of its ZlibWriter) sets no
         BFINAL and ends a dynamic or fixed row with an empty stored
         block, byte-aligned (00 00 FF FF after its 3 header bits).
  inflate  tpz_inflate's status, the decoded length or -1, on any RFC 1951
         stream (stored, fixed and dynamic blocks in sequence): -1 for a
         read past the stream, BTYPE 3, a stored LEN/NLEN mismatch, hlit
         over 286 or hdist over 30, an empty or oversubscribed
         code-length or literal table, a repeat with no previous length or
         past hlit + hdist, a code that decodes to no symbol, length
         symbol 286/287, distance symbol 30/31, a distance past the bytes
         decoded so far, or output past out_cap.  An empty or
         oversubscribed distance table fails the block's first match (-1;
         tpuzip reads uninitialised memory there), and a stored block
         after a Huffman block is read from the next byte boundary, as
         the RFC says (tpuzip's reader drops whole bytes it has buffered
         there).  The output row holds the bytes decoded until the end or
         the fault, 0 after them; an empty stream decodes to 0 bytes.
         inflate_ends also gives each row's end: the stream bytes through
         its final block (where a zlib stream's Adler-32 lies), or the
         bytes decoded before the fault.

package-merge sorts each level's items with std::sort on the weight
alone (tpuzip_host.cpp:1262), which is not stable: the order of equal
weights decides which items are paired and taken, so code lengths, and
the bytes, follow libstdc++'s introsort.  ``std_sort`` replicates it:
median of three moved to the first place, the unguarded partition, a
threshold of 16, the final insertion sort, and the heap sort at the depth
limit 2 floor(log2 n).

tpuzip has a second deflate rule, its device encoder (``deflate_batch``,
tpuzip/codecs/deflate.py:523, which its compress_from_device, ``deflate``
and zlib wrapper write): deflate_xla_encode_batch.  It is the
same links, best(p) at max_chain 1 and emit, with two changes:
  parse  greedy (deflate_parse_greedy): a match wherever best(i) reaches
         3, no lazy step (lz77_stage, :250; its candidate is prev[p], the
         nearest earlier position of the same 15-bit hash, taken when its 3
         bytes agree within 32,768 back);
  tables package-merge's levels in (weight, symbol tuple) order, Python's
         sorted over the oracle's tuples (oracle.deflate.package_merge),
         for the three trees (deflate_emit_tuple); the histograms, fixes,
         run-length coding and header are the C++ rule's, which equal
         tpuzip's _header_fields (:396).

The plain versions: the links by one stable sort of each row's hashes;
best at every position, chain link by chain link over the positions still
walking, each match length a common prefix by doubling over ranks of the
row's substrings (kernels/lz4_chain.py's); then the lazy (or greedy)
parse a Python step a token, and the tables and bits of each row one
after another, each row's histograms and fields by torch ops over its
tokens.
"""

from __future__ import annotations

import bisect
import ctypes

import torch
import torch.nn.functional as F

from tpuzip_torch.codecs.deflate import encode_cap
from tpuzip_torch.kernels import _build
from tpuzip_torch.kernels.lz4_chain import _rank_levels
from tpuzip_torch.kernels.lz4_coder import _check_pair, _mul32
from tpuzip_torch.oracle import deflate as odeflate
from tpuzip_torch.oracle.deflate import (CLCL_ORDER, DIST_TABLE,
                                         LENGTH_TABLE, canonical_codes,
                                         fixed_dist_lengths,
                                         fixed_lit_lengths)

HASH_MUL = 2654435761
HASH_BITS = 15
MIN_MATCH = 3
MAX_MATCH = 258
WINDOW = 32768        # a link further back than this ends the walk
MAX_CHAIN = 1 << 16   # links a walk can take at most
STORED_MAX = 65535    # bytes of a stored block, at most
STAGE_MAX = 1 << 16   # bytes of a row the shared links kernel takes
LINK_TILE = 1 << 15   # positions a tile of the tiled links
PARSE_SEG = 2048      # positions a segment of the device rule's parse
TOKEN_TILE = 4096     # tokens a tile of the tiled histograms and emit
THRESHOLD = 16        # libstdc++'s _S_threshold
PKG = 1 << 10         # package-merge node ids: a leaf s, or PKG + package
MATCH_SHIFT = 16      # a match token: length << 16 | distance
SCRATCH_BYTES = 20480  # a row's package-merge levels and tables in emit

LEN_BASE = [b for _, b in LENGTH_TABLE]
LEN_EXTRA = [e for e, _ in LENGTH_TABLE]
DIST_BASE = [b for _, b in DIST_TABLE]
DIST_EXTRA = [e for e, _ in DIST_TABLE]
_LEN_BASE, _LEN_EXTRA, _DIST_BASE, _DIST_EXTRA = (
    torch.tensor(t, dtype=torch.int64)
    for t in (LEN_BASE, LEN_EXTRA, DIST_BASE, DIST_EXTRA))


# ---------------------------------------------------------------- std::sort

def _lt(a: list, i: int, j: int) -> bool:
    return a[i][0] < a[j][0]


def _insertion_sort(a: list, first: int, last: int) -> None:
    for i in range(first + 1, last):
        if a[i][0] < a[first][0]:
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i)


def _unguarded_linear_insert(a: list, last: int) -> None:
    val = a[last]
    nxt = last - 1
    while val[0] < a[nxt][0]:
        a[last] = a[nxt]
        last = nxt
        nxt -= 1
    a[last] = val


def _adjust_heap(a: list, first: int, hole: int, n: int, val) -> None:
    top = hole
    child = hole
    while child < (n - 1) // 2:
        child = 2 * (child + 1)
        if a[first + child][0] < a[first + child - 1][0]:
            child -= 1
        a[first + hole] = a[first + child]
        hole = child
    if n % 2 == 0 and child == (n - 2) // 2:
        child = 2 * (child + 1)
        a[first + hole] = a[first + child - 1]
        hole = child - 1
    parent = (hole - 1) // 2
    while hole > top and a[first + parent][0] < val[0]:
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = val


def _heap_sort(a: list, first: int, last: int) -> None:
    """__partial_sort(first, last, last): make_heap, then sort_heap."""
    n = last - first
    if n >= 2:
        parent = (n - 2) // 2
        while True:
            _adjust_heap(a, first, parent, n, a[first + parent])
            if parent == 0:
                break
            parent -= 1
    while last - first > 1:
        last -= 1
        val = a[last]
        a[last] = a[first]
        _adjust_heap(a, first, 0, last - first, val)


def _move_median_to_first(a: list, result: int, x: int, y: int,
                          z: int) -> None:
    if _lt(a, x, y):
        pick = y if _lt(a, y, z) else z if _lt(a, x, z) else x
    else:
        pick = x if _lt(a, x, z) else z if _lt(a, y, z) else y
    a[result], a[pick] = a[pick], a[result]


def _unguarded_partition(a: list, first: int, last: int, pivot: int) -> int:
    while True:
        while a[first][0] < a[pivot][0]:
            first += 1
        last -= 1
        while a[pivot][0] < a[last][0]:
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _introsort_loop(a: list, first: int, last: int, depth: int) -> int:
    fallbacks = 0
    while last - first > THRESHOLD:
        if depth == 0:
            _heap_sort(a, first, last)
            return fallbacks + 1
        depth -= 1
        mid = first + (last - first) // 2
        _move_median_to_first(a, first, first + 1, mid, last - 1)
        cut = _unguarded_partition(a, first + 1, last, first)
        fallbacks += _introsort_loop(a, cut, last, depth)
        last = cut
    return fallbacks


def std_sort(a: list) -> int:
    """libstdc++'s std::sort of a list of (weight, node) pairs, in place,
    ordered by the weight alone; returns how often its heap-sort fallback
    ran."""
    n = len(a)
    if n == 0:
        return 0
    fallbacks = _introsort_loop(a, 0, n, 2 * (n.bit_length() - 1))
    if n > THRESHOLD:
        _insertion_sort(a, 0, THRESHOLD)
        for i in range(THRESHOLD, n):
            _unguarded_linear_insert(a, i)
    else:
        _insertion_sort(a, 0, n)
    return fallbacks


def package_merge(freq: list, maxbits: int) -> list:
    """tpuzip's package_merge (tpuzip_host.cpp:1244-1271): code lengths of
    at most maxbits for the symbols with freq > 0 (a lone symbol gets 1),
    each level's items ordered by std_sort."""
    lens = [0] * len(freq)
    active = [s for s, f in enumerate(freq) if f > 0]
    if len(active) == 1:
        lens[active[0]] = 1
    if len(active) < 2:
        return lens
    levels, prev = [], []
    for _ in range(maxbits):
        cur = [(freq[s], s) for s in active]
        cur += [(prev[i][0] + prev[i + 1][0], PKG + i // 2)
                for i in range(0, len(prev) - 1, 2)]
        std_sort(cur)
        levels.append([node for _, node in cur])
        prev = cur
    taken = range(min(2 * len(active) - 2, len(prev)))
    for nodes in reversed(levels):   # a taken package takes its pair below
        below = []
        for at in taken:
            node = nodes[at]
            if node < PKG:
                lens[node] += 1
            else:
                below += (2 * (node - PKG), 2 * (node - PKG) + 1)
        taken = below
    return lens


# ---------------------------------------------------------------- tables

def _reversed_codes(lens: list) -> list:
    """Canonical codes, bit-reversed for LSB-first emission (canon_codes)."""
    return [int(f"{c:0{ln}b}"[::-1], 2) if ln else 0
            for c, ln in zip(canonical_codes(lens), lens)]


def _one_code(lens: list) -> None:
    """A table with one code gets a second: both of length 1 (:1474)."""
    if sum(1 for ln in lens if ln) == 1:
        s = next(s for s, ln in enumerate(lens) if ln)
        lens[s] = 1
        lens[1 if s == 0 else 0] = 1


def _rle_lengths(all_lens: list) -> list:
    """The code-length sequence in the code-length alphabet, as the C++
    runs it (:1496-1528): (symbol, extra value, extra bits)."""
    out, s = [], 0
    while s < len(all_lens):
        v, run = all_lens[s], 1
        while s + run < len(all_lens) and all_lens[s + run] == v:
            run += 1
        s += run
        if v == 0:
            while run >= 3:
                take = min(run, 138)
                out.append((18, take - 11, 7) if take >= 11
                           else (17, take - 3, 3))
                run -= take
            out += [(0, 0, 0)] * run
        else:
            out.append((v, 0, 0))
            run -= 1
            while run >= 3:
                take = min(run, 6)
                out.append((16, take - 3, 2))
                run -= take
            out += [(v, 0, 0)] * run
    return out


def tuple_package_merge(freq: list, maxbits: int) -> list:
    """The oracle's package_merge (tpuzip's device rule: each level in
    (weight, symbol tuple) order) as a list of code lengths by symbol."""
    got = odeflate.package_merge(
        {s: f for s, f in enumerate(freq) if f}, maxbits)
    return [got.get(s, 0) for s in range(len(freq))]


def _token_tensor(tokens) -> torch.Tensor:
    """A row's tokens (a list or a tensor) as a 1-D int64 CPU tensor."""
    return torch.as_tensor(tokens, dtype=torch.int64).reshape(-1).cpu()


def _token_codes(tok: torch.Tensor):
    """(literal, length code, distance code) of each token of an int64
    tensor: the literal mask, and each match's codes (0 at literals), by
    one sorted search each (len_code, dist_code)."""
    lit = tok < 256
    lc = torch.searchsorted(_LEN_BASE, tok >> MATCH_SHIFT, right=True) - 1
    dc = torch.searchsorted(_DIST_BASE, tok & 0xFFFF, right=True) - 1
    return lit, torch.where(lit, 0, lc), torch.where(lit, 0, dc)


def block_tables(tokens, mode: int, order: str = "std"):
    """A dynamic or fixed block's tables from its tokens (a list or a
    tensor): (literal/length lengths, distance lengths, header fields as
    (value, bits) pairs).
    order "std" takes package_merge (the C++ rule), "tuple" the oracle's
    (tpuzip's device rule) for the three trees; the rest is one rule."""
    if mode == 1:
        return fixed_lit_lengths(), fixed_dist_lengths(), [(1, 1), (1, 2)]
    return freq_tables(*token_histograms(tokens), order)


def token_histograms(tokens):
    """(literal/length counts (286), distance counts (30)) of a row's
    tokens (a list or a tensor), EOB not counted."""
    tok = _token_tensor(tokens)
    lit, lc, dc = _token_codes(tok)
    lfreq = torch.bincount(torch.where(lit, tok, 257 + lc),
                           minlength=286).tolist()
    return lfreq, torch.bincount(dc[~lit], minlength=30).tolist()


def freq_tables(lfreq: list, dfreq: list, order: str = "std"):
    """A dynamic block's tables (block_tables) from its histograms (EOB
    counted once whatever lfreq[256] holds)."""
    merge = {"std": package_merge, "tuple": tuple_package_merge}[order]
    lfreq = list(lfreq[:286])
    dfreq = list(dfreq[:30])
    lfreq[256] = 1
    llen = merge(lfreq, 15)
    dlen = merge(dfreq, 15)
    _one_code(llen)
    nd = sum(1 for ln in dlen if ln)
    if nd == 0:
        dlen[0] = 1
    hlit, hdist = 286, 30
    while hlit > 257 and llen[hlit - 1] == 0:
        hlit -= 1
    while hdist > 1 and dlen[hdist - 1] == 0:
        hdist -= 1
    runs = _rle_lengths(llen[:hlit] + dlen[:hdist])
    clfreq = [0] * 19
    for sym, _, _ in runs:
        clfreq[sym] += 1
    cllen = merge(clfreq, 7)
    _one_code(cllen)
    clcode = _reversed_codes(cllen)
    hclen = 19
    while hclen > 4 and cllen[CLCL_ORDER[hclen - 1]] == 0:
        hclen -= 1
    head = [(1, 1), (2, 2), (hlit - 257, 5), (hdist - 1, 5), (hclen - 4, 4)]
    head += [(cllen[CLCL_ORDER[s]], 3) for s in range(hclen)]
    for sym, extra, bits in runs:
        head.append((clcode[sym], cllen[sym]))
        if bits:
            head.append((extra, bits))
    return llen, dlen, head


def len_code(length: int) -> int:
    """The length code 0..28 of a match length 3..258."""
    return bisect.bisect_right(LEN_BASE, length) - 1


def dist_code(dist: int) -> int:
    """The distance code 0..29 of a distance 1..32768."""
    return bisect.bisect_right(DIST_BASE, dist) - 1


def _pack_fields(values: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """The bytes of (value, bits) fields (int64 tensors, bits <= 32, each
    value below 2^bits) written LSB-first one after another, the last byte
    zero-filled: each field added into the 32-bit words it spans at its
    bit offset (the fields' bits are disjoint, so a sum is an OR)."""
    end = torch.cumsum(nbits, 0)
    total = int(end[-1]) if len(end) else 0
    pos = end - nbits
    shifted = values << (pos & 31)        # below 2^63
    words = torch.zeros(total // 32 + 2, dtype=torch.int64)
    words.index_add_(0, pos >> 5, shifted & 0xFFFFFFFF)
    words.index_add_(0, (pos >> 5) + 1, shifted >> 32)
    out = (words[:, None] >> torch.arange(0, 32, 8)) & 0xFF
    return out.reshape(-1)[: (total + 7) // 8].to(torch.uint8)


def _emit_row(row: bytes, tokens, mode: int, order: str = "std",
              fragment: bool = False) -> bytes:
    """One block's stream (deflate_impl, final_flag 1) from its tokens (a
    list or a tensor), its tables in `order` (block_tables); with
    `fragment`, deflate_impl's final_flag 0 (tpz_deflate_fragment): no
    BFINAL, and after a dynamic or fixed block's EOB an empty stored
    block's 3 bits, the byte boundary and 00 00 FF FF."""
    if mode == 2:
        out, i = bytearray(), 0
        while True:
            take = min(len(row) - i, STORED_MAX)
            last = i + take >= len(row)
            out += bytes([int(last and not fragment), take & 0xFF,
                          take >> 8, ~take & 0xFF, (~take >> 8) & 0xFF])
            out += row[i : i + take]
            i += take
            if last:
                return bytes(out)
    tok = _token_tensor(tokens)
    llen, dlen, head = block_tables(tok, mode, order)
    lv, lb, dv, db = token_fields(tok, llen, dlen)
    hv, hb = (torch.tensor([f[k] for f in head], dtype=torch.int64)
              for k in (0, 1))
    vals = torch.cat([hv, torch.stack([lv, dv], 1).reshape(-1),
                      torch.tensor(_reversed_codes(llen)[256:257])])
    bits = torch.cat([hb, torch.stack([lb, db], 1).reshape(-1),
                      torch.tensor(llen[256:257])])
    out = _pack_fields(vals, bits).numpy().tobytes()
    if not fragment:
        return out
    end = (int(bits.sum()) + 3 + 7) // 8
    out = bytes([out[0] & 0xFE]) + out[1:]
    return out + bytes(end - len(out)) + b"\x00\x00\xff\xff"


def token_fields(tokens, llen: list, dlen: list):
    """Each token's two fields under the code lengths llen and dlen, as
    int64 tensors (value, bits, value, bits): the literal or the length
    code with its extra bits, then the distance code with its extra bits
    (0 bits at a literal)."""
    tok = _token_tensor(tokens)
    lcode = torch.tensor(_reversed_codes(llen), dtype=torch.int64)
    dcode = torch.tensor(_reversed_codes(dlen), dtype=torch.int64)
    ll = torch.tensor(llen, dtype=torch.int64)
    dl = torch.tensor(dlen, dtype=torch.int64)
    lit, lc, dc = _token_codes(tok)
    sym = torch.where(lit, tok, 257 + lc)
    lv = lcode[sym] | torch.where(
        lit, 0, (tok >> MATCH_SHIFT) - _LEN_BASE[lc]) << ll[sym]
    lb = ll[sym] + torch.where(lit, 0, _LEN_EXTRA[lc])
    dv = torch.where(lit, 0, dcode[dc] | ((tok & 0xFFFF) - _DIST_BASE[dc])
                     << dl[dc])
    db = torch.where(lit, 0, dl[dc] + _DIST_EXTRA[dc])
    return lv, lb, dv, db


# ---------------------------------------------------------------- plain

def deflate_links_plain(blocks: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the links kernel: blocks (B, n) u8, lengths (B,) ->
    prev (B, n) i32, as the module note says."""
    b, n = blocks.shape
    src = F.pad(blocks, (0, 2)).to(torch.int64)
    v = src[:, :n] | (src[:, 1 : n + 1] << 8) | (src[:, 2 : n + 2] << 16)
    h = _mul32(v, HASH_MUL) >> (32 - HASH_BITS)
    order = torch.sort(h, dim=1, stable=True).indices  # positions ascending
    hs = h.gather(1, order)                              # within a hash
    earlier = F.pad(order[:, :-1], (1, 0), value=-1)
    same = F.pad(hs[:, 1:] == hs[:, :-1], (1, 0), value=False)
    prev = torch.empty_like(order).scatter_(1, order,
                                            torch.where(same, earlier, -1))
    idx = torch.arange(n, device=blocks.device)[None, :]
    limit = lengths.to(torch.int64).clamp(0, n)[:, None] - 2
    return torch.where(idx < limit, prev, -1).to(torch.int32)


def _best_matches(blocks: torch.Tensor, lengths: torch.Tensor,
                  prev: torch.Tensor, max_chain: int):
    """(best, at) of every position: the longest match that the first
    max_chain links of its chain give (0 where there is none), and the
    link that gives it first.  Only the positions still walking are
    carried from link to link."""
    b, n = blocks.shape
    dev = blocks.device
    best = torch.zeros((b, n), dtype=torch.int64, device=dev)
    at = torch.full_like(best, -1)
    prev = prev.to(torch.int64)
    r, p = torch.nonzero((prev >= 0) & (
        torch.arange(n, device=dev)[None, :] - prev <= WINDOW), as_tuple=True)
    if r.numel() == 0:
        return best, at
    levels = _rank_levels(blocks, MAX_MATCH)
    lens = lengths.to(torch.int64).clamp(0, n)
    cap = (lens[r] - p).clamp(max=MAX_MATCH)
    c = prev[r, p]
    got = torch.zeros_like(p)
    for _ in range(max_chain):
        m = torch.zeros_like(p)
        for k in range(len(levels) - 1, -1, -1):
            fits = m + (1 << k) <= cap
            ra = levels[k][r, (p + m).clamp(max=n - 1)]
            rc = levels[k][r, (c + m).clamp(max=n - 1)]
            m = torch.where(fits & (ra == rc), m + (1 << k), m)
        longer = m > got
        got = torch.where(longer, m, got)
        best[r, p] = got
        at[r, p] = torch.where(longer, c, at[r, p])
        c = prev[r, c]
        walk = (c >= 0) & (p - c <= WINDOW) & (got < cap)
        if not bool(walk.any()):
            break
        r, p, c, cap, got = r[walk], p[walk], c[walk], cap[walk], got[walk]
    return best, at


def deflate_parse_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                        prev: torch.Tensor, max_chain: int,
                        greedy: bool = False):
    """Plain version of the parse kernel: blocks (B, n) u8, lengths (B,),
    prev (B, n) i32 from the links -> (tokens (B, n) i32, zero past each
    row's, ntok (B,) i32).  greedy: no lazy step (tpuzip's device rule)."""
    b, n = blocks.shape
    best, at = _best_matches(blocks, lengths, prev, max_chain)
    tokens = torch.zeros((b, n), dtype=torch.int32)
    ntok = torch.zeros(b, dtype=torch.int32)
    for r, (row, bst, lnk, ln) in enumerate(zip(
            blocks.tolist(), best.tolist(), at.tolist(), lengths.tolist())):
        ln = min(max(ln, 0), n)
        out, i = [], 0
        while i < ln:
            m = bst[i]
            if m < MIN_MATCH:
                out.append(row[i])
                i += 1
                continue
            while not greedy and i + 1 + MIN_MATCH <= ln and \
                    bst[i + 1] > m:
                out.append(row[i])
                i += 1
                m = bst[i]
            out.append(m << MATCH_SHIFT | (i - lnk[i]))
            i += m
        tokens[r, : len(out)] = torch.tensor(out, dtype=torch.int32)
        ntok[r] = len(out)
    return tokens.to(blocks.device), ntok.to(blocks.device)


def deflate_emit_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                       tokens: torch.Tensor | None,
                       ntok: torch.Tensor | None, mode: int,
                       order: str = "std", fragment: bool = False):
    """Plain version of the emit launch (its tables and its bits): blocks
    (B, n) u8, lengths (B,), tokens (B, n) i32 and ntok (B,) from the
    parse (None in mode 2), the tables in `order` (block_tables), each row
    a stream or (fragment) a fragment (_emit_row) -> (comp (B,
    encode_cap(n)) u8, zero past each stream, clens (B,) i32)."""
    b, n = blocks.shape
    comp = torch.zeros((b, encode_cap(n)), dtype=torch.uint8)
    clens = torch.zeros(b, dtype=torch.int32)
    lens = lengths.tolist()
    toks = (tokens.cpu() if mode != 2
            else torch.zeros((b, 0), dtype=torch.int32))
    counts = ntok.tolist() if mode != 2 else [0] * b
    for r, (row, ln) in enumerate(zip(blocks.cpu().numpy(), lens)):
        ln = min(max(ln, 0), n)
        s = _emit_row(row[:ln].tobytes(), toks[r, : counts[r]], mode, order,
                      fragment)
        comp[r, : len(s)] = torch.frombuffer(bytearray(s), dtype=torch.uint8)
        clens[r] = len(s)
    return comp.to(blocks.device), clens.to(blocks.device)


class _Fault(Exception):
    pass


class _Reader:
    """An LSB-first bit reader over one stream; a read past its end
    faults."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.end = data, 0, 8 * len(data)

    def peek(self, k: int) -> int:
        at = self.pos >> 3
        word = int.from_bytes(self.data[at : at + 4], "little")
        return (word >> (self.pos & 7)) & ((1 << k) - 1)

    def bits(self, k: int) -> int:
        if self.pos + k > self.end:
            raise _Fault
        v = self.peek(k)
        self.pos += k
        return v


def _huffman(lens: list):
    """tpz_inflate's Huf::build: None for no code at all or an
    oversubscribed set; else (lookup of 2^maxlen entries by the next
    maxlen bits: (symbol, length) or None, maxlen)."""
    count = [0] * 16
    for ln in lens:
        count[ln] += 1
    if count[0] == len(lens):
        return None
    left = 1
    for ln in range(1, 16):
        left = 2 * left - count[ln]
        if left < 0:
            return None
    top = max(lens)
    table = [None] * (1 << top)
    for s, (c, ln) in enumerate(zip(_reversed_codes(lens), lens)):
        if ln:
            table[c :: 1 << ln] = [(s, ln)] * (1 << (top - ln))
    return table, top


def _decode(rd: _Reader, huff) -> int:
    if huff is None:
        raise _Fault
    table, top = huff
    hit = table[rd.peek(top)]
    if hit is None or rd.pos + hit[1] > rd.end:
        raise _Fault
    rd.pos += hit[1]
    return hit[0]


def _inflate_row(data: bytes, out: bytearray, cap: int) -> int:
    """Decode one stream into out (tpz_inflate); _Fault on any fault.
    Returns the bits its blocks took."""
    rd = _Reader(data)
    while True:
        final, btype = rd.bits(1), rd.bits(2)
        if btype == 0:
            rd.pos = -(-rd.pos // 8) * 8
            at = rd.pos >> 3
            if at + 4 > len(data):
                raise _Fault
            ln = data[at] | data[at + 1] << 8
            if ln != ~(data[at + 2] | data[at + 3] << 8) & 0xFFFF:
                raise _Fault
            at += 4
            if at + ln > len(data) or len(out) + ln > cap:
                raise _Fault
            out += data[at : at + ln]
            rd.pos = 8 * (at + ln)
        elif btype == 3:
            raise _Fault
        else:
            if btype == 1:
                lit = _huffman(fixed_lit_lengths())
                dist = _huffman(fixed_dist_lengths())
            else:
                lit, dist = _dynamic_header(rd)
            _inflate_symbols(rd, lit, dist, out, cap)
        if final:
            return rd.pos


def _dynamic_header(rd: _Reader):
    hlit, hdist, hclen = rd.bits(5) + 257, rd.bits(5) + 1, rd.bits(4) + 4
    if hlit > 286 or hdist > 30:
        raise _Fault
    cl = [0] * 19
    for i in range(hclen):
        cl[CLCL_ORDER[i]] = rd.bits(3)
    clh = _huffman(cl)
    if clh is None:
        raise _Fault
    lens = []
    while len(lens) < hlit + hdist:
        s = _decode(rd, clh)
        if s < 16:
            lens.append(s)
            continue
        if s == 16:
            if not lens:
                raise _Fault
            val, rep = lens[-1], 3 + rd.bits(2)
        else:
            val, rep = 0, 3 + rd.bits(3) if s == 17 else 11 + rd.bits(7)
        if len(lens) + rep > hlit + hdist:
            raise _Fault
        lens += [val] * rep
    lit = _huffman(lens[:hlit])
    if lit is None:
        raise _Fault
    return lit, _huffman(lens[hlit:] + [0] * (30 - hdist))


def _inflate_symbols(rd: _Reader, lit, dist, out: bytearray,
                     cap: int) -> None:
    while True:
        s = _decode(rd, lit)
        if s < 256:
            if len(out) >= cap:
                raise _Fault
            out.append(s)
            continue
        if s == 256:
            return
        s -= 257
        if s >= 29:
            raise _Fault
        mlen = LEN_BASE[s] + rd.bits(LEN_EXTRA[s])
        ds = _decode(rd, dist)
        if ds >= 30:
            raise _Fault
        d = DIST_BASE[ds] + rd.bits(DIST_EXTRA[ds])
        o = len(out)
        if d > o or o + mlen > cap:
            raise _Fault
        if d >= mlen:
            out += out[o - d : o - d + mlen]
        else:
            for k in range(mlen):
                out.append(out[o - d + k])


def inflate_batch_plain(streams: torch.Tensor, lens: torch.Tensor,
                        out_cap: int, with_ends: bool = False):
    """Plain version of inflate.cu: streams (B, w) u8, lens (B,) i32 (read
    as at most w) -> (out (B, out_cap) u8, status (B,) i64), as the module
    note says; with_ends adds inflate_ends' ends (B,) i64."""
    b, w = streams.shape
    out = torch.zeros((b, out_cap), dtype=torch.uint8)
    status = torch.zeros(b, dtype=torch.int64)
    ends = torch.zeros(b, dtype=torch.int64)
    for r, (row, ln) in enumerate(zip(streams.cpu().numpy(),
                                      lens.tolist())):
        ln = min(max(ln, 0), w)
        if ln == 0:
            continue
        got = bytearray()
        try:
            ends[r] = (_inflate_row(row[:ln].tobytes(), got, out_cap) + 7) // 8
            status[r] = len(got)
        except _Fault:
            status[r], ends[r] = -1, len(got)
        if got:
            out[r, : len(got)] = torch.frombuffer(got, dtype=torch.uint8)
    dev = streams.device
    if with_ends:
        return out.to(dev), status.to(dev), ends.to(dev)
    return out.to(dev), status.to(dev)


# ---------------------------------------------------------------- wrappers

def _lib(name: str):
    """The typed C entry point tpz_<name> of csrc/deflate_encode.cu
    (links_shared, links_tiled, links_tiled_scratch, parse, parse_greedy,
    parse_scratch, emit, emit_fragment, emit_tuple, emit_scratch) or
    csrc/inflate.cu (inflate, inflate_ends)."""
    inflate = name.startswith("inflate")
    fn = getattr(_build.load("inflate" if inflate else "deflate_encode"),
                 f"tpz_{name}" if inflate else f"tpz_deflate_{name}")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "links_shared": [vp, vp, ci, ci, vp, vp],
            "links_tiled": [vp, vp, ci, ci, vp, vp, vp],
            "links_tiled_scratch": [ci, ci],
            "parse": [vp, vp, vp, ci, ci, ci, vp, vp, vp, vp],
            "parse_greedy": [vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp],
            "parse_scratch": [ci, ci],
            "emit": [vp, vp, vp, vp, ci, ci, ci, vp, ci, vp, vp, vp],
            "emit_fragment": [vp, vp, vp, vp, ci, ci, ci, vp, ci, vp, vp,
                              vp],
            "emit_tuple": [vp, vp, ci, ci, vp, ci, vp, vp, vp],
            "emit_scratch": [ci, ci],
            "inflate": [vp, vp, ci, ci, vp, ci, vp, vp],
            "inflate_ends": [vp, vp, ci, ci, vp, ci, vp, vp, vp]}[name]
        fn.restype = ctypes.c_longlong if name.endswith("scratch") else ci
    return fn


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def links_route(n: int) -> str:
    """The links' route for rows of n bytes, by shape alone: "shared" (a
    CTA of 8 warps a row, a direct table of 2^15 u16 slots in shared
    memory) for n <= STAGE_MAX, else "tiled" (the same a tile of LINK_TILE
    positions, then a carry pass over the tiles)."""
    return "shared" if n <= STAGE_MAX else "tiled"


def deflate_links(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """prev (B, n) i32 of every row, as the module note says: blocks (B, n)
    u8, lengths (B,) i32.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/deflate_encode.cu's links on the route of links_route(n), through
    deflate_links_shared or deflate_links_tiled, which count their own
    launches."""
    _check_pair("deflate_links", blocks, lengths)
    if blocks.device.type == "cpu":
        return deflate_links_plain(blocks, lengths)
    if links_route(blocks.shape[1]) == "shared":
        return deflate_links_shared(blocks, lengths)
    return deflate_links_tiled(blocks, lengths)


def deflate_links_shared(blocks: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """deflate_links on the shared route, rows of at most STAGE_MAX bytes.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/deflate_encode.cu's shared links kernel on the current stream (no
    synchronisation)."""
    _check_pair("deflate_links_shared", blocks, lengths)
    if blocks.device.type == "cpu":
        return deflate_links_plain(blocks, lengths)
    b, n = blocks.shape
    if n > STAGE_MAX:
        raise ValueError(f"deflate_links_shared takes rows of at most "
                         f"{STAGE_MAX} bytes, not {n}")
    # a slot holds p + 1 for p below the limit, n - 2: it must fit a u16
    assert n - (MIN_MATCH - 1) <= 0xFFFF
    dev = blocks.device
    prev = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return prev
    with torch.cuda.device(dev):
        err = _lib("links_shared")(blocks.data_ptr(), lengths.data_ptr(), b,
                                   n, prev.data_ptr(), _stream(dev))
    _build.check(err, "deflate_links_shared")
    deflate_links_shared.launches += 1
    return prev


def deflate_links_tiled(blocks: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """deflate_links on the tiled route, rows of any width: each tile of
    LINK_TILE positions linked as a row of the shared route, then a carry
    pass over the tiles, its scratch 4 bytes x 2^15 a tile (the tiles'
    tables and first positions).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/deflate_encode.cu's tiled links and carry kernels on the current
    stream (no synchronisation); one launch is counted."""
    _check_pair("deflate_links_tiled", blocks, lengths)
    if blocks.device.type == "cpu":
        return deflate_links_plain(blocks, lengths)
    b, n = blocks.shape
    dev = blocks.device
    prev = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return prev
    with torch.cuda.device(dev):
        scratch = torch.empty(_lib("links_tiled_scratch")(b, n),
                              dtype=torch.uint8, device=dev)
        err = _lib("links_tiled")(blocks.data_ptr(), lengths.data_ptr(), b,
                                  n, prev.data_ptr(), scratch.data_ptr(),
                                  _stream(dev))
    _build.check(err, "deflate_links_tiled")
    deflate_links_tiled.launches += 1
    return prev


def _check_prev(blocks: torch.Tensor, prev: torch.Tensor) -> None:
    if prev.shape != blocks.shape or prev.dtype != torch.int32 or \
            prev.device != blocks.device:
        raise ValueError("prev must be (B, n) i32 beside the blocks")


def deflate_parse(blocks: torch.Tensor, lengths: torch.Tensor,
                  prev: torch.Tensor, max_chain: int):
    """The tokens of the lazy parse over prev: blocks (B, n) u8, lengths
    (B,) i32, prev (B, n) i32 from deflate_links, max_chain links a walk
    (0 or less: no match, as in the C++) ->
    (tokens (B, n) i32, zero past each row's, ntok (B,) i32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/deflate_encode.cu's best kernel (best(p) of every position), then
    its parse kernel, on the current stream (no synchronisation); one
    launch is counted."""
    _check_pair("deflate_parse", blocks, lengths)
    _check_prev(blocks, prev)
    max_chain = min(max(max_chain, 0), MAX_CHAIN)   # 0: no match at all
    if blocks.device.type == "cpu":
        return deflate_parse_plain(blocks, lengths, prev, max_chain)
    tokens, ntok = _launch_parse("parse", blocks, lengths, prev, max_chain)
    deflate_parse.launches += 1
    return tokens, ntok


def deflate_parse_greedy(blocks: torch.Tensor, lengths: torch.Tensor,
                         prev: torch.Tensor):
    """The tokens of the greedy parse over prev (tpuzip's device rule,
    lz77_stage: best(i) at max_chain 1, a match wherever it reaches 3, the
    parse going on at its end), as deflate_parse returns them.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/deflate_encode.cu's best kernel, then its greedy parse in
    segments of 2,048 positions (their maps, the chain across them, their
    tokens), on the current stream (no synchronisation); one launch is
    counted."""
    _check_pair("deflate_parse_greedy", blocks, lengths)
    _check_prev(blocks, prev)
    if blocks.device.type == "cpu":
        return deflate_parse_plain(blocks, lengths, prev, 1, greedy=True)
    tokens, ntok = _launch_parse("parse_greedy", blocks, lengths, prev, 1)
    deflate_parse_greedy.launches += 1
    return tokens, ntok


def _launch_parse(entry: str, blocks, lengths, prev, max_chain: int):
    b, n = blocks.shape
    dev = blocks.device
    tokens = torch.zeros((b, n), dtype=torch.int32, device=dev)
    ntok = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return tokens, ntok
    prev = prev.contiguous()
    best_at = torch.empty((b, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        # the greedy parse's segments: their maps, entries and first tokens
        scratch = [] if entry == "parse" else [torch.empty(
            _lib("parse_scratch")(b, n), dtype=torch.uint8, device=dev)]
        err = _lib(entry)(blocks.data_ptr(), lengths.data_ptr(),
                          prev.data_ptr(), b, n, max_chain,
                          tokens.data_ptr(), ntok.data_ptr(),
                          best_at.data_ptr(),
                          *(t.data_ptr() for t in scratch), _stream(dev))
    _build.check(err, f"deflate_{entry}")
    return tokens, ntok


def check_row_bits(n: int) -> None:
    """ValueError for rows whose stream could pass 2^31 bits: the emit
    kernel counts bit offsets in an int."""
    if 8 * encode_cap(n) >= 1 << 31:
        raise ValueError(f"deflate rows of {n} bytes: a stream may pass "
                         "2^31 bits, past the emit's bit offsets")


def _check_tokens(blocks, lengths, tokens, ntok) -> None:
    if (tokens is None or tokens.shape != blocks.shape
            or tokens.dtype != torch.int32 or ntok.shape != lengths.shape
            or ntok.dtype != torch.int32):
        raise ValueError("tokens must be (B, n) i32 and ntok (B,) i32")


def deflate_emit(blocks: torch.Tensor, lengths: torch.Tensor,
                 tokens: torch.Tensor | None, ntok: torch.Tensor | None,
                 mode: int):
    """Each row's stream from its tokens (mode 0 dynamic, 1 fixed), or from
    its bytes (mode 2 stored, tokens None): blocks (B, n) u8, lengths (B,)
    i32 -> (comp (B, encode_cap(n)) u8, zero past each stream, clens (B,)
    i32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/deflate_encode.cu's tables kernel, then its emit, on the route its
    C entry takes by the width (a block a row up to STAGE_MAX bytes, tiles
    of TOKEN_TILE tokens past it; one launch of the stored kernel in mode
    2), on the current stream (no synchronisation); one launch is
    counted."""
    return _emit("emit", blocks, lengths, tokens, ntok, mode)


def deflate_emit_fragment(blocks: torch.Tensor, lengths: torch.Tensor,
                          tokens: torch.Tensor | None,
                          ntok: torch.Tensor | None, mode: int):
    """deflate_emit's fragment mode (tpuzip's tpz_deflate_fragment, the
    batches of its ZlibWriter): no block sets BFINAL, and a dynamic or
    fixed row ends with an empty stored block, byte-aligned; a stored row
    needs none.  The same arguments and outputs, the entry
    tpz_deflate_emit_fragment, its own launch count."""
    return _emit("emit_fragment", blocks, lengths, tokens, ntok, mode)


def _emit(entry: str, blocks, lengths, tokens, ntok, mode: int):
    wrapper = {"emit": deflate_emit,
               "emit_fragment": deflate_emit_fragment}[entry]
    _check_pair(f"deflate_{entry}", blocks, lengths)
    if mode not in (0, 1, 2):
        raise ValueError(f"deflate mode {mode} is not 0, 1 or 2")
    if mode != 2:
        _check_tokens(blocks, lengths, tokens, ntok)
        check_row_bits(blocks.shape[1])
    if blocks.device.type == "cpu":
        return deflate_emit_plain(blocks, lengths, tokens, ntok, mode,
                                  fragment=entry == "emit_fragment")
    comp, clens, scratch = _emit_outputs(blocks, mode)
    if blocks.shape[0] == 0:
        return comp, clens
    b, n = blocks.shape
    if mode == 2:
        tokens = ntok = blocks
    else:
        tokens, ntok = tokens.contiguous(), ntok.contiguous()
    with torch.cuda.device(blocks.device):
        err = _lib(entry)(blocks.data_ptr(), lengths.data_ptr(),
                          tokens.data_ptr(), ntok.data_ptr(), b, n, mode,
                          comp.data_ptr(), comp.shape[1],
                          clens.data_ptr(), scratch.data_ptr(),
                          _stream(blocks.device))
    _build.check(err, f"deflate_{entry}")
    wrapper.launches += 1
    return comp, clens


def deflate_emit_tuple(blocks: torch.Tensor, lengths: torch.Tensor,
                       tokens: torch.Tensor, ntok: torch.Tensor):
    """deflate_emit in mode 0 with package-merge's levels in tpuzip's device
    rule's order, (weight, symbol tuple) (oracle.deflate.package_merge),
    for the three trees: the bytes of its deflate_batch.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/deflate_encode.cu's tables kernel in the tuple order, then its
    emit, on deflate_emit's route for the width, on the current stream (no
    synchronisation); one launch is counted."""
    _check_pair("deflate_emit_tuple", blocks, lengths)
    _check_tokens(blocks, lengths, tokens, ntok)
    check_row_bits(blocks.shape[1])
    if blocks.device.type == "cpu":
        return deflate_emit_plain(blocks, lengths, tokens, ntok, 0, "tuple")
    comp, clens, scratch = _emit_outputs(blocks, 0)
    b, n = blocks.shape
    if b == 0:
        return comp, clens
    with torch.cuda.device(blocks.device):
        err = _lib("emit_tuple")(tokens.contiguous().data_ptr(),
                                 ntok.contiguous().data_ptr(), b, n,
                                 comp.data_ptr(), comp.shape[1],
                                 clens.data_ptr(), scratch.data_ptr(),
                                 _stream(blocks.device))
    _build.check(err, "deflate_emit_tuple")
    deflate_emit_tuple.launches += 1
    return comp, clens


def _emit_scratch_bytes(b: int, n: int) -> int:
    """Bytes of an emit launch's scratch for b rows of n bytes (csrc's
    tpz_deflate_emit_scratch): each row's record, and on the tiled route
    each tile's first bit."""
    return _lib("emit_scratch")(b, n)


def _emit_outputs(blocks: torch.Tensor, mode: int):
    """(comp zeroed, clens, the rows' scratch; the blocks in mode 2) of an
    emit launch."""
    b, n = blocks.shape
    dev = blocks.device
    comp = torch.zeros((b, encode_cap(n)), dtype=torch.uint8, device=dev)
    clens = torch.empty(b, dtype=torch.int32, device=dev)
    scratch = blocks if mode == 2 else torch.empty(
        _emit_scratch_bytes(b, n), dtype=torch.uint8, device=dev)
    return comp, clens, scratch


def deflate_encode_batch(blocks: torch.Tensor, lengths: torch.Tensor,
                         max_chain: int = 128, mode: int = 0):
    """tpuzip's tpz_deflate of every row: blocks (B, n) u8, lengths (B,)
    i32 -> (comp (B, encode_cap(n)) u8, zero past each stream, clens (B,)
    i32).  Modes 0 and 1 run the links, the parse and the emit; mode 2 the
    emit alone."""
    if mode == 2:
        return deflate_emit(blocks, lengths, None, None, 2)
    prev = deflate_links(blocks, lengths)
    return deflate_emit(blocks, lengths,
                        *deflate_parse(blocks, lengths, prev, max_chain),
                        mode)


def deflate_fragment_batch(blocks: torch.Tensor, lengths: torch.Tensor,
                           max_chain: int = 64, mode: int = 0):
    """tpuzip's tpz_deflate_fragment of every row (the batches of its
    ZlibWriter, max_chain 64 there), as deflate_encode_batch returns it:
    the same links and parse, the emit's fragment mode."""
    if mode == 2:
        return deflate_emit_fragment(blocks, lengths, None, None, 2)
    prev = deflate_links(blocks, lengths)
    return deflate_emit_fragment(
        blocks, lengths, *deflate_parse(blocks, lengths, prev, max_chain),
        mode)


def deflate_xla_encode_batch(blocks: torch.Tensor, lengths: torch.Tensor):
    """tpuzip's device rule (its deflate_batch) of every row, as
    deflate_encode_batch returns it: dynamic blocks from the links, the
    greedy parse and the tables in the tuple order."""
    prev = deflate_links(blocks, lengths)
    return deflate_emit_tuple(blocks, lengths,
                              *deflate_parse_greedy(blocks, lengths, prev))


def inflate_batch(streams: torch.Tensor, lens: torch.Tensor, out_cap: int):
    """RFC 1951 inflate of every row: streams (B, w) u8, lens (B,) i32
    (read as at most w) -> (out (B, out_cap) u8, status (B,) i64), as the
    module note says.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/inflate.cu on the current stream (no synchronisation)."""
    _check_pair("inflate_batch", streams, lens)
    if streams.device.type == "cpu":
        return inflate_batch_plain(streams, lens, out_cap)
    b, w = streams.shape
    dev = streams.device
    out = torch.zeros((b, out_cap), dtype=torch.uint8, device=dev)
    status = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return out, status
    with torch.cuda.device(dev):
        err = _lib("inflate")(streams.data_ptr(), lens.data_ptr(), b, w,
                              out.data_ptr(), out_cap, status.data_ptr(),
                              _stream(dev))
    _build.check(err, "inflate")
    inflate_batch.launches += 1
    return out, status


def inflate_ends(streams: torch.Tensor, lens: torch.Tensor, out_cap: int):
    """inflate_batch, and each row's end -> (out, status, ends (B,) i64):
    where a row decoded, the stream bytes its blocks took, through its
    final block's last bit to the byte boundary (the oracle's
    bytes_consumed); where it failed, the bytes it decoded before the
    fault.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/inflate.cu's tpz_inflate_ends on the current stream (no
    synchronisation), with its own launch count."""
    _check_pair("inflate_ends", streams, lens)
    if streams.device.type == "cpu":
        return inflate_batch_plain(streams, lens, out_cap, with_ends=True)
    b, w = streams.shape
    dev = streams.device
    out = torch.zeros((b, out_cap), dtype=torch.uint8, device=dev)
    status = torch.empty(b, dtype=torch.int64, device=dev)
    ends = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return out, status, ends
    with torch.cuda.device(dev):
        err = _lib("inflate_ends")(streams.data_ptr(), lens.data_ptr(), b, w,
                                   out.data_ptr(), out_cap, status.data_ptr(),
                                   ends.data_ptr(), _stream(dev))
    _build.check(err, "inflate_ends")
    inflate_ends.launches += 1
    return out, status, ends


deflate_links_shared.launches = 0
deflate_links_tiled.launches = 0
deflate_parse.launches = 0
deflate_parse_greedy.launches = 0
deflate_emit.launches = 0
deflate_emit_fragment.launches = 0
deflate_emit_tuple.launches = 0
inflate_batch.launches = 0
inflate_ends.launches = 0
