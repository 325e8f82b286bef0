"""tpuzip's device LZ4 block encoder over a batch of blocks: the CUDA
kernels' wrappers and their plain PyTorch versions.

tpuzip encodes lz4 on the device with XLA, not Pallas:
``tpuzip/codecs/lz4.py:179`` ``encode``, its candidates from ``_candidates``
(:153) and its bytes from ``_serialize`` (:265), batched by ``encode_batch``
(:320).  ``compress_from_device`` runs it at hash_log 15 and
``compress(config.codec.lz4.device_encode=True)`` at the config's hash_log,
unclamped.  It writes other bytes than the single-probe parse of
kernels/lz4_coder.py: a position's candidate is the last earlier position
with its hash, whatever the parse did there.  csrc/lz4_dense.cu computes it
as words and a parse over them, on one of three routes, and the functions
here are theirs:

  candidates  cand[p] for every position p of a row: the last q < p whose
              4 bytes hash as p's, h = (seq * 2654435761 mod 2^32) >>
              (32 - hash_log), where h is 0 at every position for hash_log
              <= 0 or >= 33 (XLA's shift by 32 or more, or by a negative
              count); kept where p - q <= 65535, the 4 bytes are equal and
              p < length - 12, else -1.  Bytes past the row width read as
              0; bytes between the length and the width are the row's own.
              Before the filter they are kernels/lz4_links.py's links at
              table_bits(hash_log).
  parse       the greedy parse over cand: at i, cand[i]'s match is
              extended while the bytes agree before length - 5, emitted,
              and the parse goes on at its end; where cand[i] is -1, at the
              next position with a candidate.  The last literals are the
              last sequence; an empty block is the byte 0.

  words       at each candidate c of p, its match's length m (the 4 bytes,
              then while the bytes agree before length - 5) as m << 16 |
              (p - c), or MARKED | (p - c) where m reaches WORD_CAP first;
              0 without a candidate.  On the shared route (rows of at most
              65,536 bytes at table_bits(hash_log) <= 16) one kernel
              (lz4_dense_words, a direct table of u16 slots in shared
              memory); on the tiled and sorted routes the links
              (kernels/lz4_links.py), then the filter and the lengths
              (lz4_dense_words_links).
  words_parse the parse over the words: the candidates' parse, each
              match's length read from its word unless MARKED.

The route is chosen by shape alone (`encode_route`): lz4_links.links_route
at table_bits(hash_log).

The plain versions run every row at once: the candidates by one stable
sort of each row's hashes (XLA's construction), the parse one sequence a
row a step, and lz4_coder's serialisation of the sequences; the words'
lengths by doubling over ranks of the row's substrings
(kernels/lz4_chain.py's), their parse the candidates' parse.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpuzip_torch.kernels import _build, lz4_links
from tpuzip_torch.kernels.lz4_coder import (EXT, LAST_LITERALS, MF_LIMIT,
                                            MIN_MATCH, _check_pair, _gather,
                                            _read, _serialise, encode_cap)

HASH_LOG = 15          # tpuzip.codecs.lz4.HASH_LOG: compress_from_device's
# lz4_shared.cuh's: the shared routes of both encoders (this one's and
# kernels/lz4_chain.py's) take rows of at most STAGE_MAX bytes and u16
# direct tables of at most SHARED_MAX_LOG bits; a word is MARKED where its
# match reached the cap (WORD_CAP here, lz4_chain's BEST_CAP there)
STAGE_MAX = lz4_links.STAGE_MAX
SHARED_MAX_LOG = lz4_links.SHARED_MAX_LOG
MARKED = -(1 << 31)
WORD_CAP = 64          # the words' match lengths, at most (the kernel's)


def table_bits(hash_log: int) -> int:
    """The bits of h: hash_log for 1..32, else 0 (h is 0 everywhere)."""
    return hash_log if 1 <= hash_log <= 32 else 0


def encode_route(hash_log: int, n: int) -> str:
    """How lz4_dense_encode_batch encodes rows of n bytes at hash_log:
    "shared" (the words, their table in shared memory), "tiled" or
    "sorted" (kernels/lz4_links.py's links, then the words from them), each
    then the parse over the words."""
    return lz4_links.links_route(table_bits(hash_log), n)


def _filter(blocks: torch.Tensor, lengths: torch.Tensor,
            prev: torch.Tensor) -> torch.Tensor:
    """The candidates of the links prev: each kept where it lies at most
    65535 back, its 4 bytes equal p's and p < length - 12, else -1."""
    n = blocks.shape[1]
    seq, _ = lz4_links.hashes(blocks, 0)
    cand = prev.to(torch.int64)
    idx = torch.arange(n, device=blocks.device)[None, :]
    limit = lengths.to(torch.int64).clamp(0, n)[:, None] - MF_LIMIT
    ok = ((cand >= 0) & (idx - cand <= 0xFFFF) & (idx < limit)
          & (_gather(seq, cand) == seq))
    return torch.where(ok, cand, -1).to(torch.int32)


def lz4_dense_candidates_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                               hash_log: int = HASH_LOG) -> torch.Tensor:
    """Plain version of the candidates: blocks (B, n) u8, lengths (B,) ->
    cand (B, n) i32, as the module note says."""
    return _filter(blocks, lengths, lz4_links.lz4_links_plain(
        blocks, lengths, table_bits(hash_log)))


def lz4_dense_parse_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                          cand: torch.Tensor):
    """Plain version of the parse kernel: blocks (B, n) u8, lengths (B,),
    cand (B, n) i32 -> (comp (B, encode_cap(n)) u8, zero past each stream,
    clens (B,) i32)."""
    b, n = blocks.shape
    dev = blocks.device
    lens = lengths.to(torch.int64).clamp(0, n)
    end = lens - LAST_LITERALS
    col = torch.arange(n, device=dev)
    # the first position at or after j with a candidate (n where none);
    # column n for a parse that ran off the row
    nxt = torch.where(cand >= 0, col, n).flip(1).cummin(1).values.flip(1)
    nxt = F.pad(nxt, (0, 1), value=n)
    src = F.pad(blocks, (0, EXT)).to(torch.int64)
    cand = cand.to(torch.int64)
    ext = torch.arange(EXT, device=dev)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    i, anchor, nseq = zero.clone(), zero.clone(), zero.clone()
    seqs = []          # per step: (literal start, literal length, offset,
    #                     match length), one sequence of every live row
    while True:
        i = _read(nxt, i)
        live = i < n
        if not bool(live.any()):
            break
        c = _read(cand, i)
        # extend the matches forward, EXT bytes a round, up to length - 5
        m, mc, run = i + MIN_MATCH, c + MIN_MATCH, live.clone()
        while bool(run.any()):
            a, bb = m[:, None] + ext, mc[:, None] + ext
            stop = ((a >= end[:, None])
                    | (_gather(src, a) != _gather(src, bb)))
            first = torch.where(stop.any(dim=1),
                                stop.to(torch.int8).argmax(dim=1), EXT)
            m = torch.where(run, m + first, m)
            mc = torch.where(run, mc + first, mc)
            run &= first == EXT
        seqs.append((anchor, i - anchor, i - c, m - i))
        nseq += live
        anchor = torch.where(live, m, anchor)
        i = torch.where(live, m, i)
    # a row's sequences sit in its first nseq columns (a row stays live
    # until its parse ends), its last literals in column nseq
    cols = ([torch.stack(c, dim=1) for c in zip(*seqs)] if seqs
            else [zero[:, None][:, :0]] * 4)
    lit_start, lit_len, off, mlen = (F.pad(c, (0, 1)) for c in cols)
    last = nseq[:, None]
    lit_start.scatter_(1, last, anchor[:, None])
    lit_len.scatter_(1, last, (lens - anchor)[:, None])
    return _serialise(src, lit_start, lit_len, off, mlen, nseq,
                      encode_cap(n))


def _words(blocks: torch.Tensor, lengths: torch.Tensor, cand: torch.Tensor,
           cap: int) -> torch.Tensor:
    """The words of the candidates cand, their lengths capped at cap."""
    from tpuzip_torch.kernels.lz4_chain import _common_prefix, _rank_levels

    b, n = blocks.shape
    cand = cand.to(torch.int64)
    p = torch.arange(n, device=blocks.device)[None, :]
    end = lengths.to(torch.int64).clamp(0, n)[:, None] - LAST_LITERALS
    has = cand >= 0
    c = torch.where(has, cand, 0)
    most = torch.minimum(end - p, torch.tensor(cap))
    agree = _common_prefix(_rank_levels(blocks, cap), p + MIN_MATCH,
                           c + MIN_MATCH, (most - MIN_MATCH).clamp(min=0))
    m = MIN_MATCH + agree
    head = torch.where(has & (m >= cap) & (p + cap < end), MARKED, m << 16)
    return torch.where(has, head | (p - c), 0).to(torch.int32)


def lz4_dense_words_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                          hash_log: int = HASH_LOG,
                          cap: int = WORD_CAP) -> torch.Tensor:
    """Plain version of the words: blocks (B, n) u8, lengths (B,) ->
    words (B, n) i32: at a position p with a candidate c, the match's
    length m (the 4 bytes, then while the bytes agree before length - 5)
    capped at cap, as m << 16 | (p - c), or MARKED | (p - c) where m reaches
    cap and p + cap < length - 5; else 0."""
    return _words(blocks, lengths,
                  lz4_dense_candidates_plain(blocks, lengths, hash_log), cap)


def lz4_dense_words_links_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                                prev: torch.Tensor,
                                cap: int = WORD_CAP) -> torch.Tensor:
    """Plain version of the words from the links: blocks (B, n) u8, lengths
    (B,), prev (B, n) i32 (kernels/lz4_links.py's) -> the words of prev's
    candidates (the filter, then lz4_dense_words_plain's lengths)."""
    return _words(blocks, lengths, _filter(blocks, lengths, prev), cap)


def lz4_dense_words_parse_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                                words: torch.Tensor):
    """Plain version of the parse over the words: the parse's over the
    candidates they carry."""
    p = torch.arange(blocks.shape[1], device=blocks.device)[None, :]
    cand = torch.where(words != 0, p - (words & 0xFFFF), -1)
    return lz4_dense_parse_plain(blocks, lengths, cand.to(torch.int32))


def _lib(name: str):
    """The typed C entry point tpz_lz4_dense_<name> of csrc/lz4_dense.cu."""
    fn = getattr(_build.load("lz4_dense"), f"tpz_lz4_dense_{name}")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "words": [vp, vp, ci, ci, ci, vp, vp],
            "words_links": [vp, vp, vp, ci, ci, vp, vp],
            "words_parse": [vp, vp, vp, ci, ci, vp, ci, vp, vp]}[name]
        fn.restype = ci
    return fn


def lz4_dense_words(blocks: torch.Tensor, lengths: torch.Tensor,
                    hash_log: int = HASH_LOG) -> torch.Tensor:
    """The shared route's words of every row (lz4_dense_words_plain's, at
    WORD_CAP): blocks (B, n) u8 with n <= STAGE_MAX, lengths (B,) i32,
    table_bits(hash_log) <= SHARED_MAX_LOG -> words (B, n) i32.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4_dense.cu's words kernel on the current stream (no
    synchronisation)."""
    _check_pair("lz4_dense_words", blocks, lengths)
    b, n = blocks.shape
    if encode_route(hash_log, n) != "shared":
        raise ValueError(f"no shared route for rows of {n} bytes at "
                         f"hash_log {hash_log}")
    if blocks.device.type == "cpu":
        return lz4_dense_words_plain(blocks, lengths, hash_log)
    dev = blocks.device
    words = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return words
    with torch.cuda.device(dev):
        err = _lib("words")(blocks.data_ptr(), lengths.data_ptr(), b, n,
                            table_bits(hash_log), words.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4_dense_words")
    lz4_dense_words.launches += 1
    return words


def lz4_dense_words_links(blocks: torch.Tensor, lengths: torch.Tensor,
                          prev: torch.Tensor) -> torch.Tensor:
    """The words of the tiled and sorted routes (lz4_dense_words_links_plain's,
    at WORD_CAP): blocks (B, n) u8, lengths (B,) i32, prev (B, n) i32 from
    kernels/lz4_links.py -> words (B, n) i32.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4_dense.cu's words from the links on the current stream (no
    synchronisation)."""
    _check_pair("lz4_dense_words_links", blocks, lengths)
    if prev.shape != blocks.shape or prev.dtype != torch.int32 or \
            prev.device != blocks.device:
        raise ValueError("prev must be (B, n) i32 beside the blocks")
    if blocks.device.type == "cpu":
        return lz4_dense_words_links_plain(blocks, lengths, prev)
    b, n = blocks.shape
    dev = blocks.device
    words = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return words
    prev = prev.contiguous()
    with torch.cuda.device(dev):
        err = _lib("words_links")(blocks.data_ptr(), lengths.data_ptr(),
                                  prev.data_ptr(), b, n, words.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4_dense_words_links")
    lz4_dense_words_links.launches += 1
    return words


def lz4_dense_words_parse(blocks: torch.Tensor, lengths: torch.Tensor,
                          words: torch.Tensor):
    """The LZ4 streams of the greedy parse over the words: blocks (B, n)
    u8, lengths (B,) i32, words (B, n) i32 from lz4_dense_words or
    lz4_dense_words_links -> (comp (B,
    encode_cap(n)) u8, zero past each stream, clens (B,) i32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4_dense.cu's parse over words on the current stream (no
    synchronisation)."""
    _check_pair("lz4_dense_words_parse", blocks, lengths)
    if words.shape != blocks.shape or words.dtype != torch.int32 or \
            words.device != blocks.device:
        raise ValueError("words must be (B, n) i32 beside the blocks")
    if blocks.device.type == "cpu":
        return lz4_dense_words_parse_plain(blocks, lengths, words)
    b, n = blocks.shape
    cap = encode_cap(n)
    dev = blocks.device
    comp = torch.zeros((b, cap), dtype=torch.uint8, device=dev)
    clens = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return comp, clens
    words = words.contiguous()
    with torch.cuda.device(dev):
        err = _lib("words_parse")(blocks.data_ptr(), lengths.data_ptr(),
                                  words.data_ptr(), b, n, comp.data_ptr(),
                                  cap, clens.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4_dense_words_parse")
    lz4_dense_words_parse.launches += 1
    return comp, clens


def lz4_dense_encode_batch(blocks: torch.Tensor, lengths: torch.Tensor,
                           hash_log: int = HASH_LOG):
    """tpuzip's device LZ4 encode of every row, on its route
    (`encode_route`): blocks (B, n) u8, lengths (B,) i32 -> (comp (B,
    encode_cap(n)) u8, zero past each stream, clens (B,) i32).  hash_log is
    taken as it is, not clamped (any integer; outside 1..32 every position
    hashes to 0)."""
    if blocks.dim() == 2 and encode_route(hash_log,
                                          blocks.shape[1]) == "shared":
        words = lz4_dense_words(blocks, lengths, hash_log)
    else:
        words = lz4_dense_words_links(blocks, lengths, lz4_links.lz4_links(
            blocks, lengths, table_bits(hash_log)))
    return lz4_dense_words_parse(blocks, lengths, words)


lz4_dense_words.launches = 0
lz4_dense_words_links.launches = 0
lz4_dense_words_parse.launches = 0
