"""tpuzip's chained LZ4 block encoder (``config.codec.lz4.max_chain > 1``)
over a batch of blocks: the CUDA kernels' wrappers and their plain PyTorch
versions.

Off the TPU tpuzip's runner encodes lz4 at max_chain > 1 with the C++
``tpz_lz4_compress_chained`` (csrc/tpuzip_host.cpp:463-568, through
``native.lz4_compress_batch``); tpuzip has no Pallas or XLA form of it.
The port may not call it, so csrc/lz4_chain.cu replaces it in three
launches, and the functions here are theirs:

  links  prev[p] for every position p < length - 12 of a row: the last
         q < p whose 4 bytes hash as p's, h = (seq * 2654435761 mod 2^32)
         >> (32 - hash_log), hash_log outside 4..24 taken as 16; -1 where
         there is none and from length - 12 on.  No filter: the C++ chain
         links positions of one hash, whatever their bytes.
  best   a word a position: best(i) << 16 | (i - the link that gives it),
         0 where none does, and MARKED where best(i) >= cap (BEST_CAP)
         and i + cap < length - 5 (the kernel caps each extension at cap,
         and below the cap every capped length is the exact one).
  parse  the C++'s greedy parse over those chains.  best(i) walks prev[i],
         prev[prev[i]], ... while a link lies before i and at most 65535
         back (links from the links launch always do), up to
         max_chain links, and takes the longest match, extended while the
         bytes agree before length - 5 (the nearest on ties).  At i below
         length - 12: with best(i) under 4, i is a literal; else, while
         i + 1 < length - 12 and best(i + 1) > best(i), the match is
         deferred by one (i becomes a literal).  The match is emitted and
         the parse goes on at its end.  The last literals end the stream;
         an empty block is the byte 0.

Why prev is all the parse needs: the C++ inserts every position into its
chain exactly once, before the parse passes it (the lazy step inserts i
before it probes i + 1, the positions inside a match go in after it is
emitted), so when it probes i its chain holds exactly the positions before
i with i's hash, nearest first: prev's chain.  So best(i) does not depend
on the parse.

The parse reads best(i) from the words, and walks the chain exactly only
where a word is MARKED.

Routes, by shape alone (`routes`): the links of rows of at most 65,536
bytes at hash_log <= 16 take a direct table of u16 slots in shared memory
beside the staged row ("shared"), others kernels/lz4_links.py's ("tiled"
past 65,536 bytes at hash_log <= 16, "sorted" at 17-24); best stages such
rows and their links in shared memory ("staged") and walks device memory
past them ("device").

The plain versions run every row at once: the links by one stable sort of
each row's hashes (kernels/lz4_links.py's construction); best
at every position, chain link by chain link, each match length a common
prefix found by doubling over ranks of the row's substrings of 2^k bytes
(so a run costs no more than text); then the parse one sequence a row a
step, and lz4_coder's serialisation of the sequences.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpuzip_torch.codecs.lz4 import hash_log as resolve_hash_log
from tpuzip_torch.kernels import _build, lz4_links
from tpuzip_torch.kernels.lz4_coder import (LAST_LITERALS, MF_LIMIT,
                                            MIN_MATCH, _check_pair, _read,
                                            _serialise, encode_cap)
from tpuzip_torch.kernels.lz4_dense import MARKED, SHARED_MAX_LOG, STAGE_MAX

WINDOW = 0xFFFF          # a link further back than this ends the walk
MAX_CHAIN = 1 << 16      # links a walk can take at most (the window's)
BEST_CAP = 64            # the best kernel's cap (csrc/lz4_chain.cu's)


def routes(hash_log: int, n: int) -> tuple[str, str]:
    """(the links' route, best's) for rows of n bytes at hash_log: "shared",
    "tiled" or "sorted", and "staged" or "device", as the module note
    says."""
    return (lz4_links.links_route(resolve_hash_log(hash_log), n),
            "staged" if n <= STAGE_MAX else "device")


def lz4_chain_links_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                          hash_log: int = 16) -> torch.Tensor:
    """Plain version of the links: blocks (B, n) u8, lengths (B,) -> prev
    (B, n) i32, as the module note says (kernels/lz4_links.py's at the
    hash_log clamped as the C++ clamps it)."""
    return lz4_links.lz4_links_plain(blocks, lengths,
                                     resolve_hash_log(hash_log))


def _rank_levels(blocks: torch.Tensor, most: int | None = None) -> list:
    """levels[k][r, p]: the rank of row r's 2^k bytes from p among the
    row's (a byte past the row ranks below every byte), so two positions'
    next 2^k bytes are equal where their ranks are, while both stay in
    the row.  With `most`, the levels stop at the first 2^k >= most."""
    b, n = blocks.shape
    rank = blocks.to(torch.int64)
    levels = [rank]
    scale = max(n, 256) + 2
    span = 1
    while span < min(n, most or n):
        after = F.pad(rank, (0, span), value=-1)[:, span:]
        key, order = torch.sort(rank * scale + after + 1, dim=1)
        step = F.pad(key[:, 1:] != key[:, :-1], (1, 0), value=False)
        rank = torch.empty_like(rank).scatter_(1, order, step.cumsum(1))
        levels.append(rank)
        span *= 2
    return levels


def _common_prefix(levels: list, a: torch.Tensor, c: torch.Tensor,
                   cap: torch.Tensor) -> torch.Tensor:
    """min(the bytes that agree from a and from c, cap), for (B, m)
    positions a and c and caps that keep a + cap inside the row."""
    n = levels[0].shape[1]
    got = torch.zeros_like(a)
    for k in range(len(levels) - 1, -1, -1):
        fits = got + (1 << k) <= cap
        ra = levels[k].gather(1, (a + got).clamp(0, n - 1))
        rc = levels[k].gather(1, (c + got).clamp(0, n - 1))
        got = torch.where(fits & (ra == rc), got + (1 << k), got)
    return got


def _best_matches(blocks: torch.Tensor, lengths: torch.Tensor,
                  prev: torch.Tensor, max_chain: int):
    """(best, at) of every position: the longest match that the first
    max_chain links of its chain give (0 where there is none), and the link
    that gives it first."""
    b, n = blocks.shape
    dev = blocks.device
    lens = lengths.to(torch.int64).clamp(0, n)[:, None]
    p = torch.arange(n, device=dev).expand(b, n)
    prev = prev.to(torch.int64)
    cap = (lens - LAST_LITERALS - p).clamp(min=0)
    best = torch.zeros((b, n), dtype=torch.int64, device=dev)
    at = torch.full_like(best, -1)
    c = prev
    walk = (c >= 0) & (c < p) & (p - c <= WINDOW)
    if n == 0 or not bool(walk.any()):
        return best, at
    levels = _rank_levels(blocks)
    for _ in range(min(max_chain, MAX_CHAIN)):
        m = _common_prefix(levels, p, c.clamp(min=0), cap)
        longer = walk & (m > best)
        best = torch.where(longer, m, best)
        at = torch.where(longer, c, at)
        c = prev.gather(1, c.clamp(min=0))
        walk &= (c >= 0) & (c < p) & (p - c <= WINDOW)
        if not bool(walk.any()):
            break
    return best, at


def lz4_chain_best_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                         prev: torch.Tensor, max_chain: int,
                         cap: int = BEST_CAP) -> torch.Tensor:
    """Plain version of the best kernel: blocks (B, n) u8, lengths (B,),
    prev (B, n) i32 from the links -> words (B, n) i32, as the module note
    says, from the exact best and link at every position."""
    b, n = blocks.shape
    best, at = _best_matches(blocks, lengths, prev, max_chain)
    p = torch.arange(n, device=blocks.device)[None, :]
    lim = lengths.to(torch.int64).clamp(0, n)[:, None] - LAST_LITERALS
    word = torch.where(at >= 0, best << 16 | (p - at), 0)
    word = torch.where((best >= cap) & (p + cap < lim), MARKED, word)
    return word.to(torch.int32)


def _words_best(blocks, lengths, prev, words, max_chain: int):
    """(best, at) of every position as the parse kernel reads them: from
    the words where they are not MARKED, else walked exactly (on the rows
    that hold a MARKED word)."""
    w = words.to(torch.int64)
    p = torch.arange(blocks.shape[1], device=blocks.device)[None, :]
    best = torch.where(w > 0, w >> 16, 0)
    at = torch.where(w > 0, p - (w & 0xFFFF), -1)
    marked = w == MARKED
    rows = torch.nonzero(marked.any(1)).flatten()
    if len(rows):
        eb, ea = _best_matches(blocks[rows], lengths[rows], prev[rows],
                               max_chain)
        best[rows] = torch.where(marked[rows], eb, best[rows])
        at[rows] = torch.where(marked[rows], ea, at[rows])
    return best, at


def lz4_chain_parse_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                          prev: torch.Tensor, max_chain: int,
                          words: torch.Tensor):
    """Plain version of the parse kernel: blocks (B, n) u8, lengths (B,),
    prev (B, n) i32 from the links, words (B, n) i32 from best -> (comp
    (B, encode_cap(n)) u8, zero past each stream, clens (B,) i32)."""
    b, n = blocks.shape
    dev = blocks.device
    lens = lengths.to(torch.int64).clamp(0, n)
    limit = (lens - MF_LIMIT).clamp(min=0)
    best, at = _words_best(blocks, lengths, prev, words, max_chain)
    col = torch.arange(n, device=dev)
    # the first position at or after j with a match (n where none), and
    # column n for a parse that ran off the row
    nxt = torch.where(best >= MIN_MATCH, col, n).flip(1).cummin(1).values
    nxt = F.pad(nxt.flip(1), (0, 1), value=n)
    best = F.pad(best, (0, 1))
    at = F.pad(at, (0, 1), value=-1)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    i, anchor, nseq = zero.clone(), zero.clone(), zero.clone()
    seqs = []          # per step: (literal start, literal length, offset,
    #                     match length), one sequence of every live row
    while True:
        i = _read(nxt, i)
        live = i < n
        if not bool(live.any()):
            break
        while True:    # the lazy step: defer while the next is longer
            j = i + 1
            defer = live & (j < limit) & (_read(best, j) > _read(best, i))
            if not bool(defer.any()):
                break
            i = torch.where(defer, j, i)
        m = _read(best, i)
        seqs.append((anchor, i - anchor, i - _read(at, i), m))
        nseq += live
        anchor = torch.where(live, i + m, anchor)
        i = torch.where(live, i + m, i)
    cols = ([torch.stack(c, dim=1) for c in zip(*seqs)] if seqs
            else [zero[:, None][:, :0]] * 4)
    lit_start, lit_len, off, mlen = (F.pad(c, (0, 1)) for c in cols)
    last = nseq[:, None]
    lit_start.scatter_(1, last, anchor[:, None])
    lit_len.scatter_(1, last, (lens - anchor)[:, None])
    return _serialise(blocks.to(torch.int64), lit_start, lit_len, off, mlen,
                      nseq, encode_cap(n))


def _lib(name: str):
    """The typed C entry point tpz_lz4_chain_<name> of csrc/lz4_chain.cu."""
    fn = getattr(_build.load("lz4_chain"), f"tpz_lz4_chain_{name}")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "links_shared": [vp, vp, ci, ci, vp, ci, vp],
            "best": [vp, vp, vp, ci, ci, ci, vp, vp],
            "parse": [vp, vp, vp, vp, ci, ci, ci, vp, ci, vp, vp]}[name]
        fn.restype = ci
    return fn


def lz4_chain_links(blocks: torch.Tensor, lengths: torch.Tensor,
                    hash_log: int = 16) -> torch.Tensor:
    """prev (B, n) i32 of every row, as the module note says: blocks (B, n)
    u8, lengths (B,) i32; hash_log outside 4..24 taken as 16.

    A CPU tensor runs the plain version; a CUDA tensor launches, on the
    current stream (no synchronisation), csrc/lz4_chain.cu's links kernel
    on the shared route (one launch counted here), else
    kernels/lz4_links.py's tiled or sorted links (counted there)."""
    _check_pair("lz4_chain_links", blocks, lengths)
    if blocks.device.type == "cpu":
        return lz4_chain_links_plain(blocks, lengths, hash_log)
    b, n = blocks.shape
    bits = resolve_hash_log(hash_log)
    if routes(hash_log, n)[0] != "shared":
        return lz4_links.lz4_links(blocks, lengths, bits)
    dev = blocks.device
    prev = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return prev
    with torch.cuda.device(dev):
        err = _lib("links_shared")(blocks.data_ptr(), lengths.data_ptr(), b,
                                   n, prev.data_ptr(), bits,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4_chain_links")
    lz4_chain_links.launches += 1
    return prev


def _check_rows(name: str, blocks: torch.Tensor, t: torch.Tensor | None,
                max_chain: int) -> None:
    """t must be (B, n) i32 beside the blocks, max_chain at least 1."""
    if t is None or t.shape != blocks.shape or t.dtype != torch.int32 or \
            t.device != blocks.device:
        raise ValueError(f"{name} must be (B, n) i32 beside the blocks")
    if max_chain < 1:
        raise ValueError(f"max_chain must be at least 1, not {max_chain}")


def lz4_chain_best(blocks: torch.Tensor, lengths: torch.Tensor,
                   prev: torch.Tensor, max_chain: int) -> torch.Tensor:
    """The best words of every position, as the module note says: blocks
    (B, n) u8, lengths (B,) i32, prev (B, n) i32 from lz4_chain_links,
    max_chain >= 1 -> words (B, n) i32, capped at BEST_CAP.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4_chain.cu's best kernel on the current stream (no
    synchronisation)."""
    _check_pair("lz4_chain_best", blocks, lengths)
    _check_rows("prev", blocks, prev, max_chain)
    if blocks.device.type == "cpu":
        return lz4_chain_best_plain(blocks, lengths, prev, max_chain)
    b, n = blocks.shape
    dev = blocks.device
    words = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return words
    prev = prev.contiguous()
    with torch.cuda.device(dev):
        err = _lib("best")(blocks.data_ptr(), lengths.data_ptr(),
                           prev.data_ptr(), b, n, min(max_chain, MAX_CHAIN),
                           words.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4_chain_best")
    lz4_chain_best.launches += 1
    return words


def lz4_chain_parse(blocks: torch.Tensor, lengths: torch.Tensor,
                    prev: torch.Tensor, max_chain: int,
                    words: torch.Tensor | None = None):
    """The LZ4 streams of the chained greedy parse over prev: blocks (B, n)
    u8, lengths (B,) i32, prev (B, n) i32 from lz4_chain_links, max_chain
    >= 1, words (B, n) i32 from lz4_chain_best at that max_chain (without
    them the call raises ValueError) -> (comp (B, encode_cap(n)) u8, zero
    past each stream, clens (B,) i32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4_chain.cu's parse kernel on the current stream (no
    synchronisation)."""
    _check_pair("lz4_chain_parse", blocks, lengths)
    _check_rows("prev", blocks, prev, max_chain)
    _check_rows("words", blocks, words, max_chain)
    if blocks.device.type == "cpu":
        return lz4_chain_parse_plain(blocks, lengths, prev, max_chain, words)
    b, n = blocks.shape
    cap = encode_cap(n)
    dev = blocks.device
    comp = torch.zeros((b, cap), dtype=torch.uint8, device=dev)
    clens = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return comp, clens
    prev, words = prev.contiguous(), words.contiguous()
    with torch.cuda.device(dev):
        err = _lib("parse")(blocks.data_ptr(), lengths.data_ptr(),
                            prev.data_ptr(), words.data_ptr(), b, n,
                            min(max_chain, MAX_CHAIN), comp.data_ptr(), cap,
                            clens.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4_chain_parse")
    lz4_chain_parse.launches += 1
    return comp, clens


def lz4_chain_encode_batch(blocks: torch.Tensor, lengths: torch.Tensor,
                           hash_log: int = 16, max_chain: int = 8):
    """tpuzip's chained LZ4 encode of every row (the three launches):
    blocks (B, n) u8, lengths (B,) i32 -> (comp (B, encode_cap(n)) u8, zero
    past each stream, clens (B,) i32), the bytes of
    tpz_lz4_compress_chained at max_chain > 1."""
    prev = lz4_chain_links(blocks, lengths, hash_log)
    words = lz4_chain_best(blocks, lengths, prev, max_chain)
    return lz4_chain_parse(blocks, lengths, prev, max_chain, words)


lz4_chain_links.launches = 0
lz4_chain_best.launches = 0
lz4_chain_parse.launches = 0
