#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --ab DIR   # csrc/ari_encode.cu, ari_decode.cu,
                                     # bin_decode.cu, mtf.cu, bin_encode.cu,
                                     # dc_decode.cu, lz4_encode.cu,
                                     # lz4_decode.cu, rle.cu, inflate.cu,
                                     # lz4p.cu, deflate_encode.cu's links,
                                     # greedy parse, tables and emit,
                                     # lz4_chain.cu and lz4_dense.cu
                                     # against DIR's

Every container path goes through ``tpuzip_torch.compress`` /
``decompress``: the ari codec's chunk-indexed container round trip
(kernels tpuzip_torch/csrc/ari_encode.cu and ari_decode.cu); the bwt codec's,
BWT -> MTF -> ari (adds csrc/mtf.cu, one source for both directions), at
1 MiB blocks and through the segmented flag-8 path of a 100 MB block;
the bwtdc codec's, BWT -> DC -> ari (adds csrc/dc_decode.cu); the bin and
apm codecs' (csrc/bin_encode.cu, bin_decode.cu); and the decode of
containers without the chunk index (flag 2 clear, as tpuzip's run_job
writes them), through the no-index modes of ari_decode.cu and
bin_decode.cu; the lz4 codec's, tpuzip's default (csrc/lz4_encode.cu,
lz4_decode.cu, which replace tpuzip's host C++ coder: LZ4 has no Pallas
kernel), and the rle codec's (csrc/rle.cu, both directions); and, on data
that lives on the card, compress_from_device and decompress(to_device=True)
of every codec (tpuzip's device lz4 encoder, csrc/lz4_dense.cu, and
rle.cu's segment mode), and the TPZC corpus API; lz4 at max_chain > 1
(tpuzip's chained encoder, csrc/lz4_chain.cu) and the lz4p codec
(csrc/lz4p.cu, both directions); and the deflate codec (tpuzip's C++
encoder, csrc/deflate_encode.cu, and the inflate, csrc/inflate.cu), at
64 KiB blocks and at 128 KiB (the links' tiled route).
tpuzip's v1 decoder
(frequency state, ``ari_decode_indexed(algo="dot")``, the wrapper
ari_decode_dot_indexed)
runs on no container path; on the card it launches ari_decode.cu, and
phase 5 drives it and holds it against its plain version, the v1 step.
Phases, one JSON line each:

1. device   needs torch.cuda; prints nvidia-smi's name and power limit.
2. build    builds every kernel from the checkout (one nvcc each, at once),
            and reports each one's registers and spills (nvcc -Xptxas -v).
3. kernels  each kernel against its plain PyTorch version on the same
            CUDA tensors (128 blocks x 2048 symbols of skewed, random,
            constant, ragged and empty blocks; the bit coders' cut to
            their first 512 bytes), exact to the byte: ari at
            the default knobs, at threshold=512, at (16, 40000), past
            the 2^15 bound of tpuzip's packed kernels, and at increment 0
            (a model that never grows), both decoders on
            those rows and 4 garbage rows with a random chunk index (the
            dot route also equal to the cum one; its own plain version
            at the default knobs alone), ari_decode.cu's
            no-index mode at the default knobs; MTF encode and
            decode, also on rows across csrc/mtf.cu's chunks of C bytes
            (lengths 0, 1, C-1, C, C+1 and 3C+17); the DC walk on the
            DC streams of those blocks plus a
            row with a clobbered header, one with a flipped varint
            continuation bit and two past dc_decode.cu's packing (a first
            occurrence below -2^23, a length of 2^23); bin and apm encode
            and decode at the knobs
            (12, 5), (10, 4) and (11, 5) (one plain run holds all six,
            a knob pair a row), the decoder also on 4 garbage rows with
            a random chunk index and, through bin_apm.decode_batch,
            without the index; lz4 encode at hash_log 12, 16, 20 and an
            out-of-range 40, rle encode, and both decoders, on those rows
            and on 19 more: 13 under 13 bytes, runs over 255 bytes,
            periods 2, 3, 7 and 31 (offsets under 32), and corrupt streams
            (lz4: offset 0, an offset past the output, truncated literal
            and match extensions, a literal run past the stream and a
            truncated offset; rle: counts past the stream, output past
            out_cap), exact to the byte and the status; times side by
            side.  And both table routes of lz4_encode.cu: a table a row
            in device memory (those rows at each hash_log), the pool past
            POOL_BYTES (hash_log 20 on 275 rows), and 128 KiB rows whose
            repeats lie 65,533 to 70,000 bytes back, at hash_log 12, 16
            and 20; rle
            encode on 64 KiB rows of one byte, of alternating bytes and of
            runs of 255k + {0, 1, 2, 3} across rle.cu's warps and tiles
            (decoded back too), and on rows of 2045 bytes.  And both
            decoders, exact against their plain versions, on the streams
            no path feeds them (lz_decode_edges): the 128 KiB rows'
            streams at hash_log 12, 16 and 20 and lz4 streams whose
            length extensions run 300 bytes across lz4_decode.cu's tile
            ends, at out_cap 128 KiB; 64 garbage lz4 streams; tpuzip's
            XLA rle form of the 64 KiB rle rows and 64 garbage rle
            streams, pairs and chains of 255s across rle.cu's thread, warp
            and tile ends; one row of each at an out_cap well under its
            length (status -1, all 0); both of rle_decode's write routes
            reached.  And tpuzip's device lz4 encoder (csrc/lz4_dense.cu)
            past its shared route: csrc/lz4_links.cu's links, the words
            from them and their parse, on the sorted route at hash_log
            17, 20, 24 and 32 on those rows (one with random bytes past its
            length) and on the 128 KiB far rows, and at 24 and 32 on rows
            whose aligned 4-grams' hashes share their top 16 bits; on the
            tiled route on the far rows at 12 and 16 (their repeats
            65,533-70,000 back, across the 32 Ki tiles' edge), both routes
            asserted; the shared route's words and their parse at
            hash_log 0, 4, 12, 15, 16 and
            40 on those rows, on cap_rows (matches of WORD_CAP - 1,
            WORD_CAP and WORD_CAP + 1 bytes) and the 65,536-byte edge rows
            at 15 and 16; the route lz4_dense_encode_batch takes at 16 and
            17 bits and on the far rows asserted; every stream decoded
            back; rle.cu's segment mode on the mixed rows
            and the 64 KiB rle rows (runs of 255k + {0..3}: 256, 257, 511,
            512, 513 across the thread, warp and tile ends), also against
            this script's model of the form, every row decoded back.
            And tpuzip's chained lz4 encoder (csrc/lz4_chain.cu, its links,
            best words and parse) at hash_log 4, 12, 16 and 24 and
            max_chain 2, 8 and 64 on those rows with zero, b"ab" and random
            rows added; on cap_rows at 16 (matches of BEST_CAP - 1,
            BEST_CAP and BEST_CAP + 1 bytes, two earlier copies that both
            reach it, a lazy step between two MARKED words); on
            65,536-byte edge rows at 12 and 16 (the repeat 65,523 back
            taken); on the 128 KiB far rows at 12 and 16 (the tiled links);
            the links' shared, tiled and sorted (24) routes and best's
            staged and device routes asserted, every stream decoded back;
            lz4p.cu's
            pack under both rules (runs split or refused) on those rows,
            a 64 KiB row where no 4 bytes repeat (65,535 + 1 literals;
            refused under the XLA rule), a 256 KiB zero row and 64 KiB
            rows at odd skews whose batches cross the staged tiles and
            whose lengths take extensions of 2-6 bytes, and its decoder
            on every packed row and 64 garbage streams, status and
            bytes.  And the deflate coder (deflate_encode.cu's links,
            parse and tables+emit, inflate.cu) on those rows with zero,
            b"ab" and random rows added, at max_chain 1, 8 and 128 in the
            dynamic and fixed modes and stored, every stream inflated
            back; on 40 KiB rows whose repeats lie 32,767 to 32,769 back
            (the first two taken, the third refused); on 128 KiB rows
            (stored blocks of 65,535 + 65,535 + 2, rows of 65,535 and
            65,536 bytes); inflate.cu also on 64 random and 64 bit-flipped
            streams, zlib's streams of several blocks, the mixed streams
            at an out_cap under their lengths, and edge streams (codes of
            12-15 bits, which take the subtables, in dynamic and fixed
            blocks; stored blocks after Huffman blocks across the staged
            tiles), status and bytes.  And tpuzip's device deflate rule
            (deflate_encode.cu's greedy parse instance after the best
            kernel at max_chain 1, its tuple-order tables with the emit):
            on 4 KiB rows of text, zeros, b"ab" and random bytes and rows
            of 0 and 1 bytes, 64 KiB rows (the shared links) and 128 KiB
            rows (the tiled links), and the tables on the token rows built
            to stress them; the parse in segments of 2,048 positions on
            segment_rows() (zero rows and rows of period 258, whose true
            paths a walk from a segment's start never meets; matches that
            end on a segment's end and 257 past it; lengths that end
            inside the last of several segments; rows of one segment);
            the tiled links on tile_rows() (2-3 tiles of 32 Ki positions:
            hashes last seen one or two tiles back or only in the first
            and last tile, zero and b"ab" rows, lengths that end in a
            tile's last two bytes); the tiled histograms and emit (rows
            past 64 KiB, emit_tiles_check) on rows of 64 KiB + 1 and
            128 KiB (text, zero, b"ab", random, text whose tiles start on
            a word boundary and only inside words, a last tile of one
            token), both orders and both modes, and at every byte skip of
            a row's first word; every stream inflated back by inflate.cu
            and zlib.
4. main     ari: a 64 MiB text-like corpus made from a fixed seed, 64 KiB
            blocks (1024 blocks): compress + decompress on cuda, the bytes
            round-trip, the streams equal the oracle (tpuzip_torch.oracle)
            on 8 blocks; both ari kernels launched; each kernel's one
            launch on that path held, exact, against its plain version on
            the path's own tensors cut to their first 4096 symbols, as on
            the bwt paths; encode/decode MB/s, a device trace and a host
            profile of one more compress and decompress.
5. dot      the decode A/B of tpuzip's bench/tpu_r2d.py:91-106, cum
            against dot, both routes on ari_decode.cu: (a) on the ari
            path's own decode inputs (1024 stream rows), one counted
            launch of ari_decode_indexed(algo="dot") equal to the path's
            ari_decode.cu output and, exact, to the plain version on its
            first 4096 symbols; (b) on that bench's mix, 128 x 64 KiB
            blocks of random bytes, text and 6 symbols, encoded and decoded
            by both; both decode every block exactly.  CUDA-event times of
            both routes in turns (cum, dot, dot, cum) at each shape.
6. bwt      the same corpus through codec="bwt" at 1 MiB
            blocks (64 blocks): the bytes round-trip; MTF launched in both
            directions and both ari kernels launched; L and the origins
            equal the oracle's BWT on 4 blocks; each MTF launch held,
            exact, against the plain version on its own CUDA tensors cut
            to their first 12305 columns (mtf_cut: at least 3 chunks, and
            rows that end inside one; the kernel run on the cut too), and
            each ari launch on its first
            4096 symbols (both are causal, so the prefix is exact); MB/s,
            a device trace of each direction, peak memory.
7. bwt_big  one 100,000,000-byte block made from the same seed (flag 8,
            128 segments of 781,312): the bytes round-trip; each MTF launch
            held against the plain version on the first 12305 columns of
            the 128 segment rows, each ari launch on their first 4096
            symbols; MB/s and peak memory.
8. bwtdc    the 64 MiB corpus through codec="bwtdc" at 1 MiB blocks: the
            bytes round-trip; dc_decode and both ari kernels launched; the
            DC streams of 4 blocks equal the oracle's DC of the oracle's
            BWT; the DC-decode launch held, all four outputs exact, against
            the plain version on the path's own inputs cut to their first
            8192 steps (the kernel runs the cut too, so the err of an
            unfinished walk is compared as well), each ari launch on its
            first 4096 symbols; MB/s, ratio, peak memory, and a device
            trace of each direction taken in a fresh process.
9. bin      the 64 MiB corpus through codec="bin" and codec="apm" at 64 KiB
            blocks (1024 streams of 524,288 bits): the bytes round-trip;
            both bin kernels launched on each; the streams of 2 blocks
            equal the oracle's BinaryModel / ApmGate chain; each launch
            held against the plain version on the path's own tensors cut
            to the first 512 bytes of every block (kernel and plain on the
            same cut, and the path's own outputs on that prefix); MB/s,
            peak memory, and traces of apm taken in a fresh process.
10. legacy  the ari and apm paths' own containers with the chunk index
            stripped (flag 2 cleared, [u32 idx_len][idx] cut from each
            payload): decompress on cuda gives the corpus; the no-index
            decoders launched and the indexed ones not; each launch held,
            exact, against its plain version on the path's rows cut to the
            first 4096 symbols (ari) or 512 bytes (apm).
11. lz4     the 64 MiB corpus through tpuzip_torch.compress(data) with no
            codec argument (lz4 at 64 KiB blocks, 1024 blocks): the bytes
            round-trip; both lz4 kernels launched; the streams of 8 blocks
            equal the oracle's (tpuzip_torch.oracle.lz4); each launch held,
            exact, against its plain version on 8 whole blocks of the
            path's own tensors (an LZ4 stream is not causal near a block's
            end, so no prefix); MB/s, ratio, peak memory, a device trace in
            a fresh process and a host profile.
12. rle     the same through codec="rle" (csrc/rle.cu both ways).
13. serving the 64 MiB corpus as a (1024, 65536) CUDA tensor whose last row
            has length 64,536 and random bytes after it, through
            compress_from_device and decompress(to_device=True) for each of
            the seven codecs: the tensor comes back up to the lengths,
            decompress gives the corpus bytes, the container's Adler-32 is
            zlib's; lz4 launches lz4_dense.cu's shared route (its words
            and their parse) and not lz4_encode.cu, rle the segment mode;
            each new launch held, exact, against its plain version on 8
            whole rows of the path's own tensors; compress(device_encode=
            True) round-trips at hash_log 16 (the shared route) and 20
            (the sorted links, the words from them and their parse, each
            held against its plain version on 8 whole rows; the sorted
            links' scratch measured); MB/s (wall, synchronised) and peak
            memory.  deflate there is tpuzip's device rule (the shared
            links, the greedy parse, the tuple tables with the emit; never
            the C++ rule's lazy parse or std::sort tables), its parse held
            against the plain version on the first 8 rows cut to 4096
            bytes, its tables on the first 8 rows whole; traced in the lz4
            and rle paths' child.
14. corpus  the 64 MiB corpus four times (256 MiB) through compress_corpus
            and decompress (TPZC) at the defaults (lz4): the payload four
            times phase 11's; corpus_adler32 equal to zlib.adler32; bwtdc at
            1 MiB blocks through compress_corpus on 64 and 256 MiB, its peak
            device memory growing by less than 10% (phase 8's one call
            beside it).
15. lz4_chain  the 64 MiB corpus through compress(config with
            max_chain 8) and decompress: the bytes round-trip; the three
            lz4_chain.cu launches, not lz4_encode.cu; a payload smaller
            than phase 11's; each launch held, exact, against its plain
            version on the path's first 8 rows cut to 4096 bytes (the
            links also on the path's own output there, a causal prefix);
            MB/s, ratio, peak memory, and a device trace taken in a fresh
            process.  Then lz4_wide: 8 MiB of the corpus at 128 KiB blocks
            through compress(device_encode=True) at hash_log 16 and
            compress at max_chain 8, each decompressed back; both take
            csrc/lz4_links.cu's tiled links (never the shared kernels),
            held exact with the dense encoder's words on 8 whole rows.
16. lz4p    the 64 MiB corpus through compress(codec="lz4p") and
            decompress (lz4_encode.cu, lz4p.cu's pack with runs split, its
            decode), and the serving tensor through compress_from_device
            and decompress(to_device=True) (lz4_dense.cu's shared route,
            the pack unsplit): the bytes round-trip; each path's lz4p.cu
            launches held, exact, against their plain versions on 8 whole
            rows of the path's own tensors; MB/s, ratio, peak memory, and
            traces of both paths taken in a fresh process.
17. deflate the 64 MiB corpus through compress(codec="deflate") (dynamic
            blocks at max_chain 128, tpuzip's defaults) and decompress,
            then decompress(to_device=True): the bytes round-trip; the
            four launches run; zlib inflates 8 blocks' streams to the
            blocks; the encoder's launches held, exact, against their
            plain versions on the path's first 8 rows cut to 4096 bytes
            (the links also on the path's own output there, a causal
            prefix), inflate.cu on 8 whole streams of its launch; MB/s,
            ratio, peak memory, and traces of both directions taken in a
            fresh process.
18. zlib    8 MiB of the corpus through codecs.zlib_.compress and
            decompress (one stream, one row: tpuzip's device deflate rule
            on the tiled links, its parse in 4,096 segments): Python's
            zlib reads the stream back, the port reads zlib.compress(data,
            6); MB/s of each direction; each of the four launches on the
            row timed alone, with its peak device memory, and the tables
            with the emit split by kernel (the tiled route asserted).
19. streams the LZ4 frame and tpuzip.io's streaming adapters: 64 MiB
            through codecs.lz4_frame.compress_frame and decompress_frame at
            64 KiB and 4 MiB blocks, a linked frame and a frame with block
            checksums, 8 MiB through each writer and reader of
            tpuzip_torch.open (lz4f, zlib, ari, bwt, rle, mtf, dc), an LZ4
            frame nested over zlib, the zlib reader's growing output and
            the bytes after its Adler-32; every path round-trips.  The new
            kernel (csrc/xxh32.cu, both entries) and modes (lz4_decode.cu's
            history, deflate_encode.cu's fragments, inflate.cu's ends) held
            exact against their plain versions on the cuts its line names,
            each mode timed in turns against its stream instance.

Each path's launch counts are set to 0 just before it runs and read just
after; the dot route must have none on a container path.  The
kernels line counts a decoder's launches in both modes.  Then the
nvidia-smi line, a {"kernels": [...]} line (kernel times and bounds at the
main paths' shapes, the plain version's time at `plain_shape`, launches
over the paths) and, last, {"ok": true, "device": {...}}.  Any failure
exits non-zero before those.  Imports nothing of JAX and nothing of
tpuzip.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

import tpuzip_torch
from tpuzip_torch.codecs import bin_apm, bwt, dc, lz4_frame, zlib_
from tpuzip_torch.core import blocks as blk
from tpuzip_torch.core.checksum import Xxh32Stream
from tpuzip_torch.core.config import Config
from tpuzip_torch.dist import runner
from tpuzip_torch.kernels import (_build, bin_coder, dc_scan, deflate_coder,
                                  lz4_chain, lz4_coder, lz4_dense, lz4_links,
                                  lz4p_coder, mtf_scan, range_coder,
                                  range_decoder, rle_coder)
from tpuzip_torch.kernels import xxh32 as kxxh32
from tpuzip_torch.oracle import ari as oari
from tpuzip_torch.oracle import bwt as obwt
from tpuzip_torch.oracle import dc as odc
from tpuzip_torch.oracle import lz4 as olz4
from tpuzip_torch.oracle import rle as orle
from tpuzip_torch.oracle import xxh32 as oxxh32

SEED = 20261016
KNOBS = ((8, 1 << 13), (8, 512), (16, 40000), (0, 1 << 13))  # (inc, thr)
BLOCK = 1 << 16
CORPUS_BYTES = 64 << 20   # 1024 ari blocks: the JAX bench's headline shape
BWT_BLOCK = 1 << 20       # the bwt codec's default block size
BIG_BLOCK = 100_000_000   # BASELINE config 4: bwt on 100 MB blocks
MTF_PLAIN_COLS = {"bwt": 12288, "bwt_big": 12288}   # before mtf_cut()
ARI_PLAIN_COLS = 4096     # symbols of the ari prefix checks on the bwt paths
DC_PLAIN_STEPS = 8192     # runs of the DC-walk check on the bwtdc path
BIN_PLAIN_BYTES = 512     # bytes a block of the bin/apm checks on their paths
BIN_KNOBS = ((12, 5), (10, 4), (11, 5))   # (model_bits, rate)
HASH_LOGS = (12, 16, 20, 40)   # the lz4 table's bits; 40 is taken as 16
FAR_BLOCK = 1 << 17       # lz4 rows past the 65,535-byte offset bound
LZ4_WIDE_BLOCK = 1 << 17  # the lz4 wide path's blocks: the tiled links
LZ4_WIDE_BYTES = 8 << 20  # its corpus
FAR_GAPS = (65533, 65534, 65535, 65536, 65537, 70000)   # repeats' distances
HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate
SORTED_HASH_LOGS = (17, 20, 24, 32)   # lz4_dense.cu's sorted route's checks
CHAIN_DEPTHS = (2, 8, 64)         # max_chain of lz4_chain.cu's checks
CHAIN_HASH_LOGS = (4, 12, 16, 24)
CHAIN_PATH_DEPTH = 8              # max_chain of the lz4_chain path
CHAIN_PLAIN_BYTES = 4096          # bytes a row of that path's plain check
ODD_WIDTH = 2045    # lz4 rows not 16-byte aligned: the kernels' other paths
SERVE_TAIL = 64536        # the serving tensor's last row: its length
CODECS = ("lz4", "rle", "ari", "bwt", "bwtdc", "bin", "apm", "deflate")


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line of a phase, with the seconds since the script began."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - T0}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: int) -> dict:
    """The least time the card could take: the bytes moved (each input byte
    read once, each output byte written once) over the memory rate.  The
    coders and MTF do a few integer operations a byte, so bytes bound
    them."""
    return {"bound_ms": nbytes / HBM_BYTES_S * 1e3, "bound_by": "bytes",
            "bytes": int(nbytes)}


@functools.cache   # the paths share one corpus: made once, not per phase
def text_corpus(nbytes: int, seed: int) -> bytes:
    """Text-like bytes: Zipf-distributed words over a skewed alphabet,
    separated by spaces, some punctuation and line breaks."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    lp = 1.0 / np.arange(1, len(letters) + 1) ** 0.9
    vocab, maxl = 8192, 12
    wlen = rng.integers(1, maxl + 1, vocab)
    words = rng.choice(letters, size=(vocab, maxl), p=lp / lp.sum())
    wp = 1.0 / np.arange(1, vocab + 1) ** 1.1
    wp /= wp.sum()
    ntok = int(nbytes / ((wlen * wp).sum() + 1) * 1.2) + 64
    tok = rng.choice(vocab, size=ntok, p=wp)
    tlen = wlen[tok] + 1                        # the word and a separator
    ends = np.cumsum(tlen)
    ntok = int(np.searchsorted(ends, nbytes)) + 1
    tok, tlen, ends = tok[:ntok], tlen[:ntok], ends[:ntok]
    at = np.repeat(np.arange(ntok), tlen)[:nbytes]
    off = np.arange(nbytes) - (ends - tlen)[at]
    out = words[tok[at], np.minimum(off, maxl - 1)]
    sep = off == wlen[tok[at]]
    seps = np.frombuffer(b"      ,.\n", np.uint8)
    out[sep] = seps[rng.integers(0, len(seps), int(sep.sum()))]
    return out.tobytes()


def mtf_cut(cols: int) -> int:
    """Columns of an MTF plain check: at least `cols` and 3 of csrc/mtf.cu's
    chunks, plus 17, so the cut's rows end inside a chunk."""
    return max(cols, 3 * mtf_scan._lib()[1]) + 17


def mtf_edge_rows(chunk: int, seed: int):
    """(36, 3 chunk + 17) u8 blocks and lengths for the chunked MTF: each of
    the lengths 0, 1, chunk - 1, chunk, chunk + 1 and 3 chunk + 17 over
    text, random bytes, a constant, 4 symbols, Zipf-skewed bytes and
    whole permutations of the 256 symbols."""
    rng = np.random.default_rng(seed)
    n = 3 * chunk + 17
    text = np.frombuffer(text_corpus(n, seed), np.uint8)
    zipf = 1.0 / np.arange(1, 257) ** 1.3
    kinds = [text, rng.integers(0, 256, n), np.full(n, 97),
             rng.integers(0, 4, n), rng.choice(256, n, p=zipf / zipf.sum()),
             np.concatenate([rng.permutation(256)
                             for _ in range(-(-n // 256))])[:n]]
    lengths = (0, 1, chunk - 1, chunk, chunk + 1, n)
    blocks = np.stack([k for _ in lengths for k in kinds]).astype(np.uint8)
    lens = np.repeat(np.array(lengths, np.int32), len(kinds))
    blocks[np.arange(n)[None, :] >= lens[:, None]] = 0
    return blocks, lens


def mixed_blocks(b: int, n: int, seed: int):
    """(b, n) u8 blocks and lengths: skewed, random, constant, small
    alphabet and text, full or ragged, and empty blocks."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(text_corpus(b * n, seed + 1), np.uint8)
    zipf = 1.0 / np.arange(1, 257) ** 1.3
    blocks = np.zeros((b, n), np.uint8)
    lens = np.full(b, n, np.int32)
    for i in range(b):
        kind = i % 8
        if kind == 0:
            blocks[i] = rng.choice(256, n, p=zipf / zipf.sum())
        elif kind == 1:
            blocks[i] = rng.integers(0, 256, n)
        elif kind == 2:
            blocks[i] = rng.integers(0, 256)
        elif kind == 3:
            blocks[i] = rng.integers(0, 4, n)
        else:
            blocks[i] = text[i * n : (i + 1) * n]
        if kind in (5, 6):
            lens[i] = rng.integers(1, n)           # ragged
        elif kind == 7 and i % 16 == 7:
            lens[i] = 0                            # empty
        blocks[i, lens[i]:] = 0
    return blocks, lens


SOURCES = ("ari_encode", "ari_decode", "mtf", "dc_decode", "bin_encode",
           "bin_decode", "lz4_encode", "lz4_decode", "rle", "lz4_dense",
           "lz4_chain", "lz4_links", "lz4p", "deflate_encode", "inflate",
           "xxh32")


def ptxas_report(procs) -> dict:
    """Registers (one a kernel, several for a template) and spilled bytes
    of each source, from the output of its nvcc -Xptxas -v run."""
    report = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise AssertionError(f"nvcc -Xptxas -v failed on {name}:\n{err}")
        text = out + err
        report[name] = {
            "registers": [int(n) for n in
                          re.findall(r"Used (\d+) registers", text)],
            "spill_bytes": sum(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", text))}
    return report


def phase_build() -> None:
    """Every source built as the wrappers load it, and, started together
    with those builds, once more with nvcc -Xptxas -v for its registers."""
    t0 = time.perf_counter()
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{tmp}/{name}.so", str(_build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name in SOURCES}
        try:
            secs = _build.build(*SOURCES)
            ptxas = ptxas_report(procs)
        finally:
            for proc in procs.values():
                proc.kill()
                proc.wait()
    range_coder._lib()
    range_decoder._lib()
    mtf_scan._lib()
    dc_scan._lib()
    bin_coder._lib("bin_encode")
    bin_coder._lib("bin_decode")
    lz4_coder._lib("lz4_encode")
    lz4_coder._lib("lz4_decode")
    lz4_coder._lib("lz4_decode", "lz4_decode_history")
    kxxh32._lib("batch")
    kxxh32._lib("stripes")
    rle_coder._lib("rle_encode")
    rle_coder._lib("rle_encode_seg")
    rle_coder._lib("rle_decode")
    for name in ("words", "words_links", "words_parse"):
        lz4_dense._lib(name)
    for name in ("links_shared", "best", "parse"):
        lz4_chain._lib(name)
    for name in ("tiled", "sorted", "tiled_scratch", "sorted_scratch"):
        lz4_links._lib(name)
    lz4p_coder._lib("pack")
    lz4p_coder._lib("decode")
    for name in ("links_shared", "links_tiled", "links_tiled_scratch",
                 "parse", "parse_greedy", "parse_scratch", "emit",
                 "emit_fragment", "emit_tuple", "inflate", "inflate_ends"):
        deflate_coder._lib(name)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds={k: round(v, 3) for k, v in secs.items()}, ptxas=ptxas)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def timed(fn):
    """(fn(), its milliseconds between two CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def phase_kernels() -> dict:
    """Each kernel against its plain version, same CUDA inputs, exact.
    Returns each kernel's max_abs_err over the knob pairs."""
    blocks_np, lens_np = mixed_blocks(128, 2048, SEED)
    blocks = torch.from_numpy(blocks_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    errs = {"ari_encode": 0, "ari_decode": 0, "ari_decode_dot": 0}
    # 4 garbage rows beside the real ones: random bytes, a random chunk
    # index, full lengths
    grng = np.random.default_rng(SEED + 2)
    gdeltas = torch.from_numpy(grng.integers(
        0, range_decoder.MAX_DELTA + 1, (4, 2048 // 64), dtype=np.int32)).cuda()
    glens = torch.cat([lens, torch.full((4,), 2048, dtype=torch.int32,
                                        device="cuda")])
    for inc, thr in KNOBS:
        enc = range_coder.ari_encode_indexed(blocks, lens, inc, thr)
        enc_ref, enc_plain_ms = timed(
            lambda: range_coder.ari_encode_indexed_plain(blocks, lens, inc,
                                                         thr))
        streams, slens, deltas = enc
        streams = torch.cat([streams, torch.from_numpy(grng.integers(
            0, 256, (4, streams.shape[1]), dtype=np.uint8)).cuda()])
        deltas = torch.cat([deltas, gdeltas])
        dec = range_decoder.ari_decode_indexed(streams, deltas, glens, inc,
                                               thr)
        dec_ref, dec_plain_ms = timed(
            lambda: range_decoder.ari_decode_indexed_plain(streams, deltas,
                                                           glens, inc, thr))
        dot = range_decoder.ari_decode_dot_indexed(streams, deltas, glens,
                                                   inc, thr)
        # the dot route's plain version (the v1 step, 3.3 s) at the first
        # knobs; at the others the dot kernel must equal the cum kernel,
        # itself held exact against its plain version
        dot_ref, dot_plain_ms = (timed(
            lambda: range_decoder.ari_decode_dot_indexed_plain(
                streams, deltas, glens, inc, thr))
            if (inc, thr) == KNOBS[0] else (dec_ref, None))
        enc_err = max(max_err(x, y) for x, y in zip(enc, enc_ref))
        dec_err = max_err(dec, dec_ref)
        dot_err = max_err(dot, dot_ref)
        dot_is_cum = bool(torch.equal(dot, dec))
        keep = torch.arange(2048, device="cuda")[None, :] < lens[:, None]
        round_trip = bool(torch.equal(torch.where(keep, dec[:128], 0),
                                      blocks))
        times = {}
        if (inc, thr) == KNOBS[0]:
            # the no-index mode on the same rows, garbage included (the
            # real rows' streams are the same bytes without their index)
            flat = range_decoder.decode_batch(streams, glens, 2048)
            flat_ref, flat_plain_ms = timed(
                lambda: range_decoder.decode_batch_plain(streams, glens,
                                                         2048))
            errs["ari_decode_unindexed"] = max_err(flat, flat_ref)
            if errs["ari_decode_unindexed"] or not torch.equal(
                    flat[:128], dec[:128]):
                raise AssertionError("ari_decode.cu without the index "
                                     "disagrees with its plain version")
            times = {
                "encode_ms": cuda_ms(lambda: range_coder.ari_encode_indexed(
                    blocks, lens, inc, thr), 10),
                "encode_plain_ms": enc_plain_ms,
                "decode_ms": cuda_ms(
                    lambda: range_decoder.ari_decode_indexed(
                        streams, deltas, glens, inc, thr), 10),
                "decode_plain_ms": dec_plain_ms,
                "unindexed_decode_max_abs_err": errs["ari_decode_unindexed"],
                "unindexed_decode_ms": cuda_ms(
                    lambda: range_decoder.decode_batch(streams, glens, 2048),
                    10),
                "unindexed_decode_plain_ms": flat_plain_ms,
                "dot_decode_ms": cuda_ms(
                    lambda: range_decoder.ari_decode_dot_indexed(
                        streams, deltas, glens, inc, thr), 10),
                "dot_decode_plain_ms": dot_plain_ms,
            }
        emit("kernels", kernel="ari", increment=inc, threshold=thr,
             blocks=128, garbage_rows=4, symbols=2048,
             encode_max_abs_err=enc_err,
             decode_max_abs_err=dec_err, dot_decode_max_abs_err=dot_err,
             dot_equals_cum=dot_is_cum, round_trip=round_trip,
             stream_bytes=int(slens.sum()), **times)
        if enc_err or dec_err or dot_err or not dot_is_cum or not round_trip:
            raise AssertionError(f"kernel and plain version disagree at "
                                 f"knobs ({inc}, {thr})")
        errs["ari_encode"] = max(errs["ari_encode"], enc_err)
        errs["ari_decode"] = max(errs["ari_decode"], dec_err)
        errs["ari_decode_dot"] = max(errs["ari_decode_dot"], dot_err)
    enc = mtf_scan.mtf_batch(blocks, lens)
    enc_ref, enc_plain_ms = timed(lambda: mtf_scan.mtf_batch_plain(blocks,
                                                                   lens))
    dec = mtf_scan.mtf_batch(enc, lens, decode=True)
    dec_ref, dec_plain_ms = timed(
        lambda: mtf_scan.mtf_batch_plain(enc, lens, decode=True))
    # rows across csrc/mtf.cu's chunk boundaries: lengths 0, 1, C-1, C, C+1
    # and 3C+17; decoded as they are too (not only an encode's output)
    chunk = mtf_scan._lib()[1]
    eblocks, elens = (torch.from_numpy(a).cuda()
                      for a in mtf_edge_rows(chunk, SEED + 4))
    eenc = mtf_scan.mtf_batch(eblocks, elens)
    edec = mtf_scan.mtf_batch(eenc, elens, decode=True)
    eraw = mtf_scan.mtf_batch(eblocks, elens, decode=True)
    edge_errs = [max_err(eenc, mtf_scan.mtf_batch_plain(eblocks, elens)),
                 max_err(edec, mtf_scan.mtf_batch_plain(eenc, elens, True)),
                 max_err(eraw, mtf_scan.mtf_batch_plain(eblocks, elens,
                                                        True))]
    errs["mtf_encode"] = max(max_err(enc, enc_ref), edge_errs[0])
    errs["mtf_decode"] = max(max_err(dec, dec_ref), *edge_errs[1:])
    round_trip = bool(torch.equal(dec, blocks)) and bool(
        torch.equal(edec, eblocks))
    emit("kernels", kernel="mtf", blocks=128, symbols=2048,
         chunk_bytes=chunk, edge_rows=list(eblocks.shape),
         edge_lengths=sorted(set(elens.tolist())),
         edge_max_abs_err=max(edge_errs),
         encode_max_abs_err=errs["mtf_encode"],
         decode_max_abs_err=errs["mtf_decode"], round_trip=round_trip,
         encode_ms=cuda_ms(lambda: mtf_scan.mtf_batch(blocks, lens), 10),
         encode_plain_ms=enc_plain_ms,
         decode_ms=cuda_ms(lambda: mtf_scan.mtf_batch(enc, lens,
                                                      decode=True), 10),
         decode_plain_ms=dec_plain_ms)
    if errs["mtf_encode"] or errs["mtf_decode"] or not round_trip:
        raise AssertionError("mtf kernel and plain version disagree")
    errs["dc_decode"] = dc_kernel_check(blocks, lens)
    # the plain bit coder takes a step a bit: its rows cut to
    # BIN_PLAIN_BYTES, as on the bin and apm paths
    errs.update(bin_kernel_check(blocks[:, :BIN_PLAIN_BYTES].contiguous(),
                                 lens.clamp(max=BIN_PLAIN_BYTES)))
    errs.update(lz_kernel_check(blocks_np, lens_np))
    return errs


def dc_kernel_check(blocks, lens) -> int:
    """The DC walk on the DC streams of the blocks, plus a row whose header
    field first[0] is clobbered to 0xFFFFFFFF (it reads as -1), a row
    with a varint's continuation bit flipped, and two rows past
    csrc/dc_decode.cu's packing (a first occurrence below -2^23, a length
    of 2^23), which it walks by the exact step throughout: kernel against
    plain, all four outputs, exact."""
    comp, clens = dc.encode_batch(blocks, lens)
    comp = comp[:, : int(clens.max())]
    bad_hdr, bad_var = comp[0].clone(), comp[4].clone()
    bad_hdr[4:8] = 0xFF
    bad_var[dc.HDR + 1] ^= 0x80
    comp = torch.cat([comp, bad_hdr[None], bad_var[None]]).contiguous()
    clens = torch.cat([clens, clens[[0, 4]]])
    vals, first, length = dc.decode_inputs(comp, clens, blocks.shape[1])
    wide = first[[4, 4]].clone()
    wide[0, 5] = -(1 << 24)
    vals = torch.cat([vals, vals[[4, 4]]]).contiguous()
    first = torch.cat([first, wide]).contiguous()
    length = torch.cat([length, torch.stack([length[4], length.new_tensor(
        1 << 23)])])
    out = dc_scan.dc_decode_lanes(vals, first, length)
    ref, plain_ms = timed(
        lambda: dc_scan.dc_decode_lanes_plain(vals, first, length))
    err = max(max_err(x, y) for x, y in zip(out, ref))
    back, _, flags = dc.decode_batch(comp, clens, blocks.shape[1])
    round_trip = bool(torch.equal(back[:-2], blocks))
    emit("kernels", kernel="dc_decode", streams=vals.shape[0],
         steps=vals.shape[1], max_abs_err=err, round_trip=round_trip,
         err_flags=out[3].tolist()[-4:],
         ms=cuda_ms(lambda: dc_scan.dc_decode_lanes(vals, first, length),
                    10), plain_ms=plain_ms)
    if err or not round_trip or flags[:-2].any():
        raise AssertionError("dc_decode kernel and plain version disagree")
    return err


def knob_rows(pairs, b: int) -> dict:
    """Per-row knobs of one plain run holding several launches: each
    (model_bits, rate, use_apm) repeated over its b rows."""
    return {name: torch.tensor(col, device="cuda").repeat_interleave(b)
            for name, col in zip(("model_bits", "rate", "use_apm"),
                                 zip(*pairs))}


def bin_kernel_check(blocks, lens) -> dict:
    """bin and apm at each knob pair: encode and decode kernels against one
    plain run of each direction over all six settings (a knob pair a row),
    exact; the decoder on the blocks' streams and 4 garbage rows (random
    bytes, a random chunk index, full bit counts), with the chunk index
    and, through bin_apm.decode_batch, without it; the round trip; times
    side by side."""
    b, n_bytes = blocks.shape
    pairs = [(bits, rate, apm) for apm in (False, True)
             for bits, rate in BIN_KNOBS]
    encs = [bin_coder.bin_encode_indexed(blocks, lens, *p) for p in pairs]
    grng = np.random.default_rng(SEED + 3)
    garbage = torch.from_numpy(grng.integers(
        0, 256, (4, encs[0][0].shape[1]), dtype=np.uint8)).cuda()
    gdeltas = torch.from_numpy(grng.integers(
        0, bin_coder.MAX_DELTA + 1, (4, encs[0][2].shape[1]),
        dtype=np.int32)).cuda()
    glens = torch.cat([lens, torch.full((4,), n_bytes, dtype=torch.int32,
                                        device="cuda")])
    gbits = (8 * glens).to(torch.int32)
    rows = [(torch.cat([e[0], garbage]), torch.cat([e[2], gdeltas]))
            for e in encs]
    decs = [bin_coder.bin_decode_indexed(s, d, gbits, *p)
            for (s, d), p in zip(rows, pairs)]
    flats = [bin_apm.decode_batch(s, glens, n_bytes, *p)
             for (s, _), p in zip(rows, pairs)]
    knobs = knob_rows(pairs, b)
    gknobs = knob_rows(pairs, b + 4)
    n = len(pairs)
    enc_ref, enc_plain_ms = timed(lambda: bin_coder.bin_encode_indexed_plain(
        blocks.repeat(n, 1), lens.repeat(n), **knobs))
    dec_ref, dec_plain_ms = timed(lambda: bin_coder.bin_decode_indexed_plain(
        torch.cat([r[0] for r in rows]), torch.cat([r[1] for r in rows]),
        gbits.repeat(n), **gknobs))
    flat_ref, flat_plain_ms = timed(
        lambda: bin_coder.bin_decode_indexed_plain(
            torch.cat([r[0] for r in rows]), None, gbits.repeat(n),
            **gknobs, nc=encs[0][2].shape[1])[:, :n_bytes])
    enc_err = max(max_err(x, y[j * b : (j + 1) * b])
                  for j, e in enumerate(encs) for x, y in zip(e, enc_ref))
    g = b + 4
    dec_err = max(max_err(d, dec_ref[j * g : (j + 1) * g])
                  for j, d in enumerate(decs))
    flat_err = max(max_err(d, flat_ref[j * g : (j + 1) * g])
                   for j, d in enumerate(flats))
    keep = torch.arange(n_bytes, device="cuda")[None, :] < lens[:, None]
    round_trip = all(torch.equal(torch.where(keep, d[:b, :n_bytes], 0),
                                 blocks) for d in decs + flats)
    times = {f"{'apm' if p[2] else 'bin'}_{p[0]}_{p[1]}": {
        "encode_ms": cuda_ms(lambda: bin_coder.bin_encode_indexed(
            blocks, lens, *p), 5),
        "decode_ms": cuda_ms(lambda: bin_coder.bin_decode_indexed(
            r[0], r[1], gbits, *p), 5),
        "unindexed_decode_ms": cuda_ms(lambda: bin_apm.decode_batch(
            r[0], glens, n_bytes, *p), 5)} for r, p in zip(rows, pairs)}
    emit("kernels", kernel="bin", blocks=b, garbage_rows=4, bytes=n_bytes,
         knobs=pairs, encode_max_abs_err=enc_err, decode_max_abs_err=dec_err,
         unindexed_decode_max_abs_err=flat_err, round_trip=round_trip,
         times=times, encode_plain_ms_all_six=enc_plain_ms,
         decode_plain_ms_all_six=dec_plain_ms,
         unindexed_decode_plain_ms_all_six=flat_plain_ms)
    if enc_err or dec_err or flat_err or not round_trip:
        raise AssertionError("bin kernels and plain versions disagree")
    return {"bin_encode": enc_err, "bin_decode": dec_err,
            "bin_decode_unindexed": flat_err}


def lz_rows(n: int, seed: int):
    """(19, n) u8 rows and lengths for the lz4 and rle checks beside the
    mixed blocks: 13 rows of 0 to 12 bytes (all literals in LZ4), runs of
    255 to 700 bytes, text with runs in it, and periods 2, 3, 7 and 31
    (LZ4 offsets under 32)."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(text_corpus(n, seed), np.uint8)
    runs = np.repeat(rng.integers(0, 256, n), rng.integers(255, 701, n))[:n]
    mixed = text.copy()
    for at in range(0, n - 700, 900):
        mixed[at : at + rng.integers(256, 700)] = rng.integers(0, 256)
    rows = [text] * 13 + [runs, mixed] + [
        np.resize(rng.integers(0, 256, p), n) for p in (2, 3, 7, 31)]
    lens = np.array(list(range(13)) + [n] * 6, np.int32)
    rows = np.stack(rows).astype(np.uint8)
    rows[np.arange(n)[None, :] >= lens[:, None]] = 0
    return rows, lens


def far_rows(seed: int):
    """(8, FAR_BLOCK) u8 rows and lengths for lz4_encode.cu whose repeats
    lie near the 65,535-byte offset bound: for each
    distance D of FAR_GAPS, 3000 random bytes, zeros, and the same bytes
    again at D, then zeros (the zeros' own match lies D - 1 back); and
    random bytes of periods 65,535 and 65,536."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((len(FAR_GAPS) + 2, FAR_BLOCK), np.uint8)
    for r, gap in enumerate(FAR_GAPS):
        stretch = rng.integers(1, 256, 3000)
        rows[r, :3000] = stretch
        rows[r, gap : gap + 3000] = stretch
    for r, period in ((-2, 65535), (-1, 65536)):
        rows[r] = np.resize(rng.integers(0, 256, period), FAR_BLOCK)
    return rows, np.full(len(rows), FAR_BLOCK, np.int32)


def cap_rows(n: int, cap: int, seed: int):
    """(4, n) u8 rows and lengths (n >= 8 cap + 1000) of random bytes
    around repeats at the edge of lz4_chain.cu's best cap: matches of cap -
    1, cap and cap + 1 bytes; two earlier copies that both reach the cap
    (the nearer the shorter, so the exact walk must pass it); a lazy step
    between two positions that both reach it (at i, "A" and a match of cap
    + 20 bytes; at i + 1, one of 2 cap + 30); and the first and second
    kinds in one row.  Each repeat ends at a byte that differs."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (4, n)).astype(np.uint8)

    def copy(r, to, frm, length):
        rows[r, to : to + length] = rows[r, frm : frm + length]
        rows[r, to + length] = rows[r, frm + length] ^ 0x5A

    step = n // 8
    for k, extra in enumerate((-1, 0, 1)):
        for r in (0, 3):
            copy(r, 4 * step + k * (cap + 40), 100 + k * (cap + 20),
                 cap + extra)
    copy(1, step, 100, cap + 10)           # the nearer, shorter copy
    copy(1, 5 * step, 100, cap + 30)       # reaches both
    copy(3, 6 * step, 100, cap + 30)
    tail = rng.integers(0, 256, 2 * cap + 31).astype(np.uint8)
    far = 2 * cap + 200
    rows[2, 100] = 0x41
    rows[2, 101 : 101 + cap + 21] = tail[: cap + 21]
    rows[2, 101 + cap + 20] ^= 0x5A        # "A" + cap + 20 of the tail
    rows[2, far - 1] = 0x42
    rows[2, far : far + 2 * cap + 31] = tail
    rows[2, 5 * step] = 0x41
    rows[2, 5 * step + 1 : 5 * step + 2 * cap + 32] = tail
    rows[2, 5 * step + 2 * cap + 31] ^= 0x5A
    return rows, np.full(4, n, np.int32)


def run_rows(n: int, seed: int):
    """(4, n) u8 rows and lengths of text broken by byte runs of 1 to 1,000
    bytes (zeros, then any byte; the last row runs only): the shared
    routes' scans of 128 positions that lie inside a run skip the queue
    while it holds the text's positions, and runs start and end at every
    offset of a scan."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(text_corpus(4 * n, seed + 1), np.uint8)
    rows = np.zeros((4, n), np.uint8)
    for r in range(4):
        at = 0
        while at < n:
            if r < 3:
                k = min(int(rng.integers(1, 300)), n - at)
                rows[r, at : at + k] = text[r * n + at : r * n + at + k]
                at += k
            k = int(rng.integers(1, 1001))
            rows[r, at : at + k] = 0 if r == 0 else rng.integers(0, 256)
            at += k
    return rows, np.full(4, n, np.int32)


def stage_edge_rows(seed: int):
    """(2, 65536) u8 rows and lengths at the shared-memory routes' edge: 16
    random bytes, zeros, and at the last matchable positions (65,515 and
    65,523: a position matches below length - 12) the first 6 and 13 of
    those bytes again, two other bytes between, the farthest repeats a
    65,536-byte row holds (the chained walk takes the one 65,523 back);
    and a zero row."""
    n = 1 << 16
    rows = np.zeros((2, n), np.uint8)
    rows[0, :16] = np.random.default_rng(seed).integers(1, 256, 16)
    rows[0, 65515:65521] = rows[0, :6]
    rows[0, 65521:65523] = (0xFE, 0xFD)    # no match across the gap
    rows[0, 65523:] = rows[0, :13]
    return rows, np.full(2, n, np.int32)


def lz4_offsets(stream: bytes) -> list:
    """The match offsets of an LZ4 stream, in order."""
    def length(nibble: int, p: int):
        if nibble == 15:
            while stream[p] == 255:
                nibble += 255
                p += 1
            nibble += stream[p]
            p += 1
        return nibble, p

    out, p = [], 0
    while p < len(stream):
        token = stream[p]
        lit, p = length(token >> 4, p + 1)
        p += lit
        if p >= len(stream):
            break
        out.append(stream[p] | stream[p + 1] << 8)
        _, p = length(token & 15, p + 2)
    return out


def rle_long_rows():
    """(6, BLOCK) u8 rows and lengths for rle.cu's scans: a constant row,
    alternating bytes, and runs of 255k + {0, 1, 2, 3} bytes (k up to 8),
    each byte other than its neighbours', after 0, 511 and 4095 single
    bytes, so that runs cross the warps' (512-byte) and the tiles'
    (4096-byte) boundaries; the last row cut at 65,535 bytes."""
    rng = np.random.default_rng(SEED + 8)
    runs = [255 * k + d for k in range(9) for d in range(4) if k or d]
    rows = [np.full(BLOCK, 0x61), np.resize([0x61, 0x62], BLOCK)]
    for start in (0, 511, 4095, 4095):
        parts, val = [np.resize([1, 2], start)], 3
        while sum(map(len, parts)) < BLOCK:
            for r in rng.permutation(runs):
                parts.append(np.full(r, val % 253 + 3))
                val += 1
        rows.append(np.concatenate(parts)[:BLOCK])
    lens = np.array([BLOCK] * 5 + [BLOCK - 1], np.int32)
    rows = np.stack(rows).astype(np.uint8)
    rows[-1, -1] = 0
    return rows, lens


def first_offset(stream: bytes) -> int:
    """Where an LZ4 stream's first offset sits: after its token, its literal
    run's extension and its literals."""
    lit, p = stream[0] >> 4, 1
    if lit == 15:
        while stream[p] == 255:
            lit += 255
            p += 1
        lit += stream[p]
        p += 1
    return p + lit


def lz4_corrupt_streams(text: bytes) -> list:
    """(name, stream) of each fault the LZ4 decoder's status reports."""
    good = olz4.compress_block(text)
    at = first_offset(good)
    return [("offset 0", good[:at] + b"\x00\x00" + good[at + 2:]),
            ("offset past output", good[:at] + b"\xff\xff" + good[at + 2:]),
            ("truncated literal ext", b"\xf0\xff"),
            ("truncated match ext", b"\x1fa\x01\x00\xff"),
            ("truncated offset", b"\x10a\x01"),
            ("literal run past stream", b"\x50ab")]


def rle_corrupt_streams() -> list:
    """(name, stream) of each fault the rle decoder's status reports."""
    return [("count past stream", b"aa"),
            ("count past stream after 255", b"aa\xff"),
            ("count past stream after 255 255", b"xyzz\xff\xff")]


def padded(streams, width: int):
    """(len, width) u8 rows holding the streams, and their lengths, on the
    card."""
    rows = np.zeros((len(streams), width), np.uint8)
    for i, st in enumerate(streams):
        rows[i, : len(st)] = np.frombuffer(st, np.uint8)
    return (torch.from_numpy(rows).cuda(),
            torch.tensor([len(st) for st in streams], dtype=torch.int32,
                         device="cuda"))


def lz_kernel_check(blocks_np, lens_np) -> dict:
    """lz4 and rle, each kernel against its plain version on the mixed
    blocks and lz_rows(), exact to the byte and the status: lz4 encode at
    each of HASH_LOGS, rle encode; each decoder on the encoded rows plus
    corrupt streams (lz4_corrupt_streams(), rle_corrupt_streams(), and for
    both, streams whose literals or fill pass out_cap), every corrupt row's
    status -1 and every encoded row decoded back, and on lz_decode_edges()'
    rows; times side by side."""
    rows_np, rlens_np = lz_rows(blocks_np.shape[1], SEED + 5)
    x = torch.from_numpy(np.concatenate([blocks_np, rows_np])).cuda()
    xl = torch.from_numpy(np.concatenate([lens_np, rlens_np])).cuda()
    b, n = x.shape
    text = text_corpus(n + 300, SEED + 6)
    errs, res = {}, {}
    for hl in HASH_LOGS:
        enc = lz4_coder.lz4_encode_batch(x, xl, hl)
        ref, plain_ms = timed(
            lambda: lz4_coder.lz4_encode_batch_plain(x, xl, hl))
        err = max(max_err(a, c) for a, c in zip(enc, ref))
        errs["lz4_encode"] = max(errs.get("lz4_encode", 0), err)
        res[f"lz4_encode_hash_log_{hl}"] = {
            "max_abs_err": err, "stream_bytes": int(enc[1].sum()),
            "route": lz4_route(x, hl),
            "ms": cuda_ms(lambda: lz4_coder.lz4_encode_batch(x, xl, hl), 10),
            "plain_ms": plain_ms}
        if hl == 16:
            lz4_enc = enc
    res["lz4_encode_routes"] = lz4_route_check(x, xl, n)
    errs["lz4_encode"] = max(errs["lz4_encode"],
                             res["lz4_encode_routes"]["max_abs_err"])
    rle_enc = rle_coder.rle_encode_batch(x, xl)
    ref, plain_ms = timed(lambda: rle_coder.rle_encode_batch_plain(x, xl))
    errs["rle_encode"] = max(max_err(a, c) for a, c in zip(rle_enc, ref))
    res["rle_encode"] = {
        "max_abs_err": errs["rle_encode"],
        "stream_bytes": int(rle_enc[1].sum()),
        "ms": cuda_ms(lambda: rle_coder.rle_encode_batch(x, xl), 10),
        "plain_ms": plain_ms}
    res["rle_long_rows"] = rle_long_check(x, xl, n)
    errs["rle_encode"] = max(errs["rle_encode"],
                             res["rle_long_rows"]["max_abs_err"])
    # past out_cap: a text stream of n + 300 bytes, and for rle a fill
    # and a literal stretch longer than n
    lz4_bad = lz4_corrupt_streams(text[:900]) + [
        ("output past out_cap", olz4.compress_block(text))]
    stretch = bytes((np.arange(n + 10) % 251).astype(np.uint8))
    rle_bad = rle_corrupt_streams() + [
        ("fill past out_cap", orle.encode(b"a" * (n + 10))),
        ("literals past out_cap", orle.encode(stretch))]
    for codec, (comp, clens), bad in (("lz4", lz4_enc, lz4_bad),
                                      ("rle", rle_enc, rle_bad)):
        coder = LZ[codec][0]
        extra, elens = padded([st for _, st in bad], comp.shape[1])
        comp = torch.cat([comp, extra]).contiguous()
        clens = torch.cat([clens, elens]).contiguous()
        wrapper = getattr(coder, f"{codec}_decode_batch")
        dec = wrapper(comp, clens, n)
        ref, plain_ms = timed(lambda: getattr(
            coder, f"{codec}_decode_batch_plain")(comp, clens, n))
        err = max(max_err(a, c) for a, c in zip(dec, ref))
        keep = torch.arange(n, device="cuda")[None, :] < xl[:, None]
        back = (torch.equal(dec[1][:b], xl.to(torch.int64))
                and torch.equal(torch.where(keep, dec[0][:b], 0), x))
        status = dec[1][b:].tolist()
        errs[f"{codec}_decode"] = err
        res[f"{codec}_decode"] = {
            "max_abs_err": err, "round_trip": back,
            "corrupt_status": dict(zip((k for k, _ in bad), status)),
            "ms": cuda_ms(lambda: wrapper(comp, clens, n), 10),
            "plain_ms": plain_ms}
        if err or not back or any(st != -1 for st in status):
            raise AssertionError(f"{codec} decode: kernel and plain version "
                                 f"disagree, or a row decoded wrong: "
                                 f"{res[f'{codec}_decode']}")
    res["decode_edges"], edge_errs = lz_decode_edges(n)
    for name, e in edge_errs.items():
        errs[name] = max(errs[name], e)
    res["dense"], dense_errs = dense_kernel_check(x, xl, n)
    res["rle_segments"] = rle_segments_check(x, xl)
    errs.update(dense_errs, rle_encode_seg=res["rle_segments"]["max_abs_err"])
    res["chain"], chain_errs = chain_kernel_check(x, xl, n)
    for k, e in chain_errs.items():   # both encoders take the links
        errs[k] = max(errs.get(k, 0), e)
    res["lz4p"], lz4p_errs = lz4p_kernel_check(x, xl, n)
    deflate_errs = deflate_kernel_check(x, xl, n)
    errs.update(**lz4p_errs, **deflate_errs)
    emit("kernels", kernel="lz4_rle", rows=b, bytes=n,
         short_rows=int((rlens_np < 13).sum()), **res)
    if errs["lz4_encode"] or errs["rle_encode"]:
        raise AssertionError(f"lz4 or rle encode disagrees with its plain "
                             f"version: {res}")
    return errs


def links_check(rows, lens, bits: int):
    """csrc/lz4_links.cu's links of rows at bits, on the route their shape
    takes (tiled or sorted), against the plain links, exact -> (the
    record, the links, the plain links)."""
    route = lz4_links.links_route(bits, rows.shape[1])
    run = getattr(lz4_links, f"lz4_links_{route}")
    prev = run(rows, lens, bits)
    pref, plain_ms = timed(lambda: lz4_links.lz4_links_plain(rows, lens,
                                                             bits))
    rec = {"rows": list(rows.shape), "route": route, "bits": bits,
           "max_abs_err": max_err(prev, pref), "plain_ms": plain_ms,
           "ms": cuda_ms(lambda: run(rows, lens, bits), 3)}
    return rec, prev, pref


def wide_dense_check(rows, lens, hash_log: int) -> dict:
    """csrc/lz4_dense.cu past its shared route on rows at hash_log: the
    links (csrc/lz4_links.cu), the words from them and the parse over the
    words, each against its plain version on the same inputs (the words on
    the plain links, the parse on the plain words, and the plain words
    equal to lz4_dense_words_plain's), exact; the streams decoded back by
    lz4_decode."""
    rec, prev, pref = links_check(rows, lens, lz4_dense.table_bits(hash_log))
    words = lz4_dense.lz4_dense_words_links(rows, lens, pref)
    wref, words_plain_ms = timed(
        lambda: lz4_dense.lz4_dense_words_links_plain(rows, lens, pref))
    got = lz4_dense.lz4_dense_words_parse(rows, lens, words)
    ref = lz4_dense.lz4_dense_words_parse_plain(rows, lens, wref)
    err = {f"lz4_links_{rec['route']}": rec["max_abs_err"],
           "lz4_dense_words_links": max(
               max_err(words, wref), max_err(wref, lz4_dense.
                                             lz4_dense_words_plain(
                                                 rows, lens, hash_log))),
           "lz4_dense_words_parse": max(max_err(a, c)
                                        for a, c in zip(got, ref))}
    out, status = lz4_coder.lz4_decode_batch(*got, rows.shape[1])
    keep = torch.arange(rows.shape[1], device="cuda")[None, :] < lens[:, None]
    back = (torch.equal(status, lens.to(torch.int64))
            and torch.equal(out, torch.where(keep, rows, 0)))
    rec.update(max_abs_err=err, round_trip=back, words_plain_ms=words_plain_ms,
               marked=int((words < 0).sum()), stream_bytes=int(got[1].sum()),
               comp=got, links_ms=rec.pop("ms"),
               words_ms=cuda_ms(lambda: lz4_dense.lz4_dense_words_links(
                   rows, lens, prev), 3),
               parse_ms=cuda_ms(lambda: lz4_dense.lz4_dense_words_parse(
                   rows, lens, words), 3))
    if any(err.values()) or not back:
        raise AssertionError(f"lz4_dense at hash_log {hash_log} on "
                             f"{list(rows.shape)}: max_abs_err {err}, round "
                             f"trip {back}")
    return rec


def shared_check(rows, lens, hash_log: int) -> dict:
    """The shared route of csrc/lz4_dense.cu on rows at hash_log against
    its plain versions (the words; the parse over the plain words), exact,
    and the streams decoded back."""
    words = lz4_dense.lz4_dense_words(rows, lens, hash_log)
    wref, words_plain_ms = timed(
        lambda: lz4_dense.lz4_dense_words_plain(rows, lens, hash_log))
    got = lz4_dense.lz4_dense_words_parse(rows, lens, words)
    ref, parse_plain_ms = timed(
        lambda: lz4_dense.lz4_dense_words_parse_plain(rows, lens, wref))
    err = {"lz4_dense_words": max_err(words, wref),
           "lz4_dense_words_parse": max(max_err(a, c)
                                        for a, c in zip(got, ref))}
    out, status = lz4_coder.lz4_decode_batch(*got, rows.shape[1])
    keep = torch.arange(rows.shape[1], device="cuda")[None, :] < lens[:, None]
    back = (torch.equal(status, lens.to(torch.int64))
            and torch.equal(out, torch.where(keep, rows, 0)))
    if any(err.values()) or not back:
        raise AssertionError(f"lz4_dense's shared route at hash_log "
                             f"{hash_log} on {list(rows.shape)}: max_abs_err "
                             f"{err}, round trip {back}")
    return {"rows": list(rows.shape), "max_abs_err": err, "round_trip": back,
            "marked": int((words < 0).sum()),
            "stream_bytes": int(got[1].sum()),
            "words_plain_ms": words_plain_ms, "parse_plain_ms": parse_plain_ms,
            "words_ms": cuda_ms(lambda: lz4_dense.lz4_dense_words(
                rows, lens, hash_log), 3),
            "parse_ms": cuda_ms(lambda: lz4_dense.lz4_dense_words_parse(
                rows, lens, words), 3)}


def dense_shared_check(xr, xl):
    """The shared route (encode_route "shared": rows of at most 65,536
    bytes, hash bits at most 16) against its plain versions: on the mixed
    rows (one with random bytes past its length) at hash_log 0, 4, 12, 15,
    16 and 40; on cap_rows(4096, WORD_CAP) (matches of WORD_CAP - 1,
    WORD_CAP and WORD_CAP + 1 bytes), run_rows(4096) (scans inside a run
    while the queue holds text) and stage_edge_rows() (65,536 bytes:
    the route's widest rows, its u16 slots up to 65,524) at 15 and 16; the
    mixed rows cut to ODD_WIDTH bytes (rows not 16-byte aligned) at 15.  And
    the route choice through lz4_dense_encode_batch: the words and their
    parse alone at 16 bits on the mixed rows, the sorted links, the words
    from them and the parse at 17 bits, the same with the tiled links on
    the 128 KiB far rows at 15.  Returns (the results, each launch's
    max_abs_err)."""
    res = {f"hash_log_{hl}": shared_check(xr, xl, hl)
           for hl in (0, 4, 12, 15, 16, 40)}
    # rows of an odd width: not 16-byte aligned, so no TMA stream; the
    # words read at every skew
    odd = xr[:, :ODD_WIDTH].contiguous()
    res["odd_width_hash_log_15"] = shared_check(
        odd, xl.clamp(max=ODD_WIDTH), 15)
    for name, (rx, rl) in (
            ("cap_rows", cap_rows(4096, lz4_dense.WORD_CAP, SEED + 14)),
            ("run_rows", run_rows(4096, SEED + 42)),
            ("stage_edge", stage_edge_rows(SEED + 15))):
        rx, rl = torch.from_numpy(rx).cuda(), torch.from_numpy(rl).cuda()
        for hl in (15, 16):
            res[f"{name}_hash_log_{hl}"] = shared_check(rx, rl, hl)
    far, flens = (torch.from_numpy(a).cuda() for a in far_rows(SEED + 9))
    routes = {}
    names = ("lz4_dense_words", "lz4_links_tiled", "lz4_links_sorted",
             "lz4_dense_words_links", "lz4_dense_words_parse")
    for name, rows, lens, hl in (("mixed_16", xr, xl, 16),
                                 ("mixed_17", xr, xl, 17),
                                 ("far_15", far, flens, 15)):
        with counted_run() as (calls, counts):
            lz4_dense.lz4_dense_encode_batch(rows, lens, hl)
        calls.clear()
        routes[name] = [k for k in names if counts[k]]
    res["routes"] = routes
    if routes != {"mixed_16": [names[0], names[4]],
                  "mixed_17": list(names[2:]),
                  "far_15": [names[1], *names[3:]]}:
        raise AssertionError(f"lz4_dense took a wrong route: {routes}")
    errs = {k: max(rec["max_abs_err"][k] for rec in res.values()
                   if "max_abs_err" in rec)
            for k in ("lz4_dense_words", "lz4_dense_words_parse")}
    return res, errs


def dense_kernel_check(x, xl, n: int):
    """csrc/lz4_dense.cu (tpuzip's device lz4 encoder) against its plain
    versions past its shared route (wide_dense_check: csrc/lz4_links.cu's
    links, the words from them, their parse): the sorted route at
    SORTED_HASH_LOGS on the mixed rows, one of them with random bytes past
    its length (the caller's, which enter no hash that counts), and on
    far_rows() (128 KiB, repeats 65,533 to 70,000 back), and on
    top_bits_rows() (every aligned 4-gram's hash sharing its top 16 bits)
    at 24 and 32; the tiled route on the far rows at 12 and 16; on the far
    rows the offsets up to 65,535 taken and the others refused.  Then the
    shared route (dense_shared_check).  Returns (the results, each
    launch's max_abs_err)."""
    xr = x.clone()
    ragged = int(torch.nonzero(xl[:128] < n)[-1])   # a ragged mixed row
    tail = n - int(xl[ragged])
    xr[ragged, n - tail:] = torch.from_numpy(np.random.default_rng(
        SEED + 10).integers(0, 256, tail, np.uint8)).cuda()
    res = {"past_length_row": ragged}
    far, flens = (torch.from_numpy(a).cuda() for a in far_rows(SEED + 9))
    top = torch.from_numpy(top_bits_rows(8, 4096, SEED + 17)).cuda()
    tlens = torch.full((8,), 4096, dtype=torch.int32, device="cuda")
    for hl in SORTED_HASH_LOGS:
        res[f"hash_log_{hl}"] = wide_dense_check(xr, xl, hl)
        res[f"far_hash_log_{hl}"] = wide_dense_check(far, flens, hl)
    for hl in (24, 32):
        res[f"top_bits_hash_log_{hl}"] = wide_dense_check(top, tlens, hl)
    for hl in (12, 16):
        res[f"far_hash_log_{hl}"] = wide_dense_check(far, flens, hl)
    for hl in (12, 16) + SORTED_HASH_LOGS:
        comp, clens = res[f"far_hash_log_{hl}"]["comp"]
        offs = [max(lz4_offsets(comp[r, : int(clens[r])].cpu().numpy()
                                .tobytes()), default=0)
                for r in range(len(FAR_GAPS))]
        res[f"far_hash_log_{hl}"]["max_offset"] = offs
        if offs[:3] != [65533, 65534, 65535] or max(offs[3:]) >= 65533:
            raise AssertionError(f"lz4_dense at hash_log {hl}: repeats near "
                                 f"the offset bound taken or refused wrong: "
                                 f"{offs}")
    errs, routes = {}, set()
    for rec in res.values():
        if isinstance(rec, dict):
            rec.pop("comp")
            routes.add(rec["route"])
            for k, e in rec["max_abs_err"].items():
                errs[k] = max(errs.get(k, 0), e)
    res["routes"] = sorted(routes)
    if routes != {"tiled", "sorted"}:
        raise AssertionError(f"lz4_dense: a route was not reached: {res}")
    res["shared"], shared_errs = dense_shared_check(xr, xl)
    for k, e in shared_errs.items():
        errs[k] = max(errs.get(k, 0), e)
    return res, errs


def rle_segments_check(x, xl) -> dict:
    """rle.cu's encoder in its segment mode (tpuzip's XLA form) against its
    plain version on the mixed rows and rle_long_rows() (runs of 255k + {0,
    1, 2, 3}, so of 256, 257, 511, 512 and 513, across the thread, warp
    and tile ends), exact; the long rows also against rle_segments(), this
    script's own model of that form, and every row decoded back by
    rle_decode."""
    long_rows, long_lens = (torch.from_numpy(a).cuda()
                            for a in rle_long_rows())
    res, err = {}, 0
    for name, rows, lens in (("mixed", x, xl), ("long", long_rows, long_lens)):
        got = rle_coder.rle_encode_segments_batch(rows, lens)
        ref, plain_ms = timed(
            lambda: rle_coder.rle_encode_segments_batch_plain(rows, lens))
        e = max(max_err(a, c) for a, c in zip(got, ref))
        out, status = rle_coder.rle_decode_batch(*got, rows.shape[1])
        keep = (torch.arange(rows.shape[1], device="cuda")[None, :]
                < lens[:, None])
        back = (torch.equal(status, lens.to(torch.int64))
                and torch.equal(out, torch.where(keep, rows, 0)))
        res[name] = {"rows": list(rows.shape), "max_abs_err": e,
                     "round_trip": back, "plain_ms": plain_ms,
                     "stream_bytes": int(got[1].sum()),
                     "ms": cuda_ms(lambda: rle_coder.rle_encode_segments_batch(
                         rows, lens), 3)}
        if name == "long":
            comp, clens = (a.cpu().numpy() for a in got)
            model = [rle_segments(long_rows[r, : int(long_lens[r])].cpu()
                                  .numpy().tobytes())
                     for r in range(len(clens))]
            res[name]["model_equal"] = all(
                comp[r, : clens[r]].tobytes() == model[r]
                for r in range(len(clens)))
            back = back and res[name]["model_equal"]
        err = max(err, e)
        if e or not back:
            raise AssertionError(f"rle segment mode on the {name} rows: "
                                 f"{res[name]}")
    res["max_abs_err"] = err
    return res


def chain_check(rows, lens, hash_log: int, depths) -> dict:
    """The three launches of csrc/lz4_chain.cu on rows at hash_log against
    their plain versions (the links; best at each max_chain of depths on
    the plain links; the parse on the plain links and words), exact, and
    the streams decoded back by lz4_decode."""
    route, best_route = lz4_chain.routes(hash_log, rows.shape[1])
    prev = lz4_chain.lz4_chain_links(rows, lens, hash_log)
    pref, links_plain_ms = timed(
        lambda: lz4_chain.lz4_chain_links_plain(rows, lens, hash_log))
    # the links kernel of the route: lz4_chain.cu's shared one, or
    # csrc/lz4_links.cu's
    links = "lz4_chain_links" if route == "shared" else f"lz4_links_{route}"
    err = {links: max_err(prev, pref), "lz4_chain_best": 0,
           "lz4_chain_parse": 0}
    keep = torch.arange(rows.shape[1], device="cuda")[None, :] < lens[:, None]
    rec = {"rows": list(rows.shape), "route": route, "best_route": best_route,
           "links_ms": cuda_ms(lambda: lz4_chain.lz4_chain_links(
               rows, lens, hash_log), 3), "links_plain_ms": links_plain_ms}
    for mc in depths:
        wref = lz4_chain.lz4_chain_best_plain(rows, lens, pref, mc)
        err["lz4_chain_best"] = max(err["lz4_chain_best"], max_err(
            lz4_chain.lz4_chain_best(rows, lens, pref, mc), wref))
        words = lz4_chain.lz4_chain_best(rows, lens, prev, mc)
        got = lz4_chain.lz4_chain_parse(rows, lens, prev, mc, words)
        ref, plain_ms = timed(lambda: lz4_chain.lz4_chain_parse_plain(
            rows, lens, pref, mc, wref))
        e = max(max_err(a, c) for a, c in zip(got, ref))
        out, status = lz4_coder.lz4_decode_batch(*got, rows.shape[1])
        back = (torch.equal(status, lens.to(torch.int64))
                and torch.equal(out, torch.where(keep, rows, 0)))
        rec[f"max_chain_{mc}"] = {
            "max_abs_err": e, "round_trip": back,
            "stream_bytes": int(got[1].sum()), "plain_ms": plain_ms,
            "marked": int((words == lz4_chain.MARKED).sum()),
            "best_ms": cuda_ms(lambda: lz4_chain.lz4_chain_best(
                rows, lens, prev, mc), 3),
            "ms": cuda_ms(lambda: lz4_chain.lz4_chain_parse(
                rows, lens, prev, mc, words), 3), "comp": got}
        err["lz4_chain_parse"] = max(err["lz4_chain_parse"], e)
        if not back:
            raise AssertionError(f"lz4_chain streams at hash_log {hash_log}, "
                                 f"max_chain {mc} did not decode back")
    rec["max_abs_err"] = err
    return rec


def chain_kernel_check(x, xl, n: int):
    """csrc/lz4_chain.cu (tpuzip's chained lz4 encoder) against its plain
    versions: on the mixed rows (constant, random and small-alphabet rows,
    runs, periods 2 to 31, rows of 0 to 12 bytes) with an all-zero row, a
    b"ab" row and random rows added (the stop at length - 5 on the first
    link, the lazy step on every match, every position probed), at
    hash_log 4, 12, 16 and 24 and max_chain 2, 8 and 64; on
    cap_rows(4096, BEST_CAP) (matches of BEST_CAP - 1, BEST_CAP and BEST_CAP
    + 1 bytes, two earlier copies that both reach it, a lazy step between
    two MARKED words) at 16, max_chain 8 and 64; on run_rows(4096) (scans
    inside a run while the queue holds text) at 12 and 16, max_chain 8 and
    64; on
    stage_edge_rows() (65,536 bytes: the shared routes' widest rows, the
    farthest repeat they hold) at 12 and 16; the mixed rows cut to
    ODD_WIDTH bytes and the far rows to 131,069 (rows not 16-byte aligned:
    no TMA, best at every skew) at 16; on far_rows() (128 KiB: the tiled
    links, best from device memory; repeats 65,533 to 70,000 back) at 12
    and 16, max_chain 8, the offsets up to 65,535 taken and the others
    refused.  Every route of the links (shared, tiled, sorted: hash_log
    24) and of best (staged, device) must be reached.  Returns (the
    results, each launch's max_abs_err)."""
    rng = np.random.default_rng(SEED + 12)
    extra = np.stack([np.zeros(n), np.resize([97, 98], n),
                      rng.integers(0, 256, n), rng.integers(0, 256, n)])
    rows = torch.cat([x, torch.from_numpy(extra.astype(np.uint8)).cuda()])
    lens = torch.cat([xl, torch.full((4,), n, dtype=torch.int32,
                                     device="cuda")])
    res = {}
    for hl in CHAIN_HASH_LOGS:
        res[f"hash_log_{hl}"] = chain_check(rows, lens, hl, CHAIN_DEPTHS)
    cx, cl = (torch.from_numpy(a).cuda()
              for a in cap_rows(4096, lz4_chain.BEST_CAP, SEED + 40))
    res["cap_rows"] = chain_check(cx, cl, 16, (8, 64))
    rx, rl = (torch.from_numpy(a).cuda() for a in run_rows(4096, SEED + 41))
    for hl in (12, 16):
        res[f"run_rows_hash_log_{hl}"] = chain_check(rx, rl, hl, (8, 64))
    # rows of an odd width: no TMA, the rows staged byte by byte and the
    # parse reading device memory; and 128 KiB rows so cut, best walking
    # device memory at every skew
    res["odd_width"] = chain_check(rows[:, :ODD_WIDTH].contiguous(),
                                   lens.clamp(max=ODD_WIDTH), 16, (8, 64))
    ex, el = (torch.from_numpy(a).cuda() for a in stage_edge_rows(SEED + 13))
    for hl in (12, 16):
        rec = chain_check(ex, el, hl, (CHAIN_PATH_DEPTH,))
        comp, clens = rec[f"max_chain_{CHAIN_PATH_DEPTH}"]["comp"]
        rec["max_offset"] = max(lz4_offsets(comp[0, : int(clens[0])].cpu()
                                            .numpy().tobytes()))
        if rec["max_offset"] != 65523:
            raise AssertionError(f"lz4_chain at hash_log {hl}: the 65,536-"
                                 f"byte row's farthest repeat not taken: "
                                 f"{rec['max_offset']}")
        res[f"stage_edge_hash_log_{hl}"] = rec
    far, flens = (torch.from_numpy(a).cuda() for a in far_rows(SEED + 9))
    for hl in (12, 16):
        rec = chain_check(far, flens, hl, (CHAIN_PATH_DEPTH,))
        comp, clens = rec[f"max_chain_{CHAIN_PATH_DEPTH}"]["comp"]
        offs = [max(lz4_offsets(comp[r, : int(clens[r])].cpu().numpy()
                                .tobytes()), default=0)
                for r in range(len(FAR_GAPS))]
        rec["max_offset"] = offs
        if offs[:3] != [65533, 65534, 65535] or max(offs[3:]) >= 65533:
            raise AssertionError(f"lz4_chain at hash_log {hl}: repeats near "
                                 f"the offset bound taken or refused wrong: "
                                 f"{offs}")
        res[f"far_hash_log_{hl}"] = rec
    res["far_odd_width"] = chain_check(
        far[:, : FAR_BLOCK - 3].contiguous(),
        flens.clamp(max=FAR_BLOCK - 3), 16, (CHAIN_PATH_DEPTH,))
    errs = {}
    routes, best_routes = set(), set()
    for rec in res.values():
        routes.add(rec["route"])
        best_routes.add(rec["best_route"])
        for k, e in rec["max_abs_err"].items():
            errs[k] = max(errs.get(k, 0), e)
        for v in rec.values():
            if isinstance(v, dict):
                v.pop("comp", None)
    res["routes"], res["best_routes"] = sorted(routes), sorted(best_routes)
    if routes != {"shared", "tiled", "sorted"} or \
            best_routes != {"staged", "device"} or any(errs.values()):
        raise AssertionError(f"lz4_chain disagrees with its plain version, "
                             f"or a route was not reached: {res}")
    return res, errs


def unrepeated_row(n: int, seed: int) -> np.ndarray:
    """n random bytes in which no 4 bytes repeat (no LZ4 match at all): the
    first such row of seeds from `seed` on."""
    while True:
        row = np.random.default_rng(seed).integers(0, 256, n, np.uint8)
        words = row[:-3].astype(np.uint32) | (row[1:-2].astype(np.uint32)
                                              << 8) | (
            row[2:-1].astype(np.uint32) << 16) | (row[3:].astype(np.uint32)
                                                  << 24)
        if len(np.unique(words)) == len(words):
            return row
        seed += 1


def lz4p_garbage(seed: int) -> list:
    """64 lz4p streams of up to 6 sequences of random lengths and offsets
    (at most 354 bytes of output): a quarter as made, a quarter with one
    bit flipped, a quarter cut short, a quarter with bytes after the
    literals (which a decoder accepts)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(64):
        nseq = int(rng.integers(0, 7))
        ll = rng.integers(0, 20, nseq)
        ml = np.where(rng.random(nseq) < 0.7, rng.integers(4, 40, nseq), 0)
        offs, o = np.zeros(nseq, np.int64), 0
        for t in range(nseq):
            o += int(ll[t])
            offs[t] = int(rng.integers(1, o + 1)) if ml[t] and o else 0
            ml[t] = ml[t] if offs[t] else 0
            o += int(ml[t])
        g = bytearray(struct.pack("<II", nseq, o)
                      + b"".join(c.astype("<u2").tobytes()
                                 for c in (ll, ml, offs))
                      + rng.integers(0, 256, int(ll.sum()),
                                     np.uint8).tobytes())
        if k % 4 == 1:
            g[int(rng.integers(0, len(g)))] ^= 1 << int(rng.integers(0, 8))
        elif k % 4 == 2:
            g = g[: int(rng.integers(0, len(g)))]
        elif k % 4 == 3:
            g += rng.integers(0, 256, int(rng.integers(1, 20)),
                              np.uint8).tobytes()
        out.append(bytes(g))
    return out


def lz4p_stream(seqs, lits: bytes) -> bytes:
    """An lz4p stream of sequences (literal length, match length, offset)
    and their literals."""
    ll, ml, off = (np.array([q[c] for q in seqs], "<u2") for c in range(3))
    orig = int(ll.astype(np.int64).sum() + ml.astype(np.int64).sum())
    if len(lits) != int(ll.astype(np.int64).sum()):
        raise ValueError("the literals do not add up")
    return (struct.pack("<II", len(seqs), orig) + ll.tobytes()
            + ml.tobytes() + off.tobytes() + lits)


def lz4p_serial(stream: bytes) -> bytes:
    """A valid lz4p stream's bytes, a sequence and a byte at a time."""
    nseq = struct.unpack_from("<I", stream)[0]
    ll, ml, off = np.frombuffer(stream, "<u2", 3 * nseq, 8).reshape(3, nseq)
    lits = memoryview(stream)[8 + 6 * nseq :]
    out, at = bytearray(), 0
    for a, m, d in zip(ll.tolist(), ml.tolist(), off.tolist()):
        out += lits[at : at + a]
        at += a
        for _ in range(m):
            out.append(out[-d])
    return bytes(out)


def lz4p_edge_streams(seed: int) -> list:
    """[(stream, its bytes)] of lz4p streams no encoder of the paths
    writes, for the decode's batches: 65,535 literals, then matches
    65,535 back (a batch of more than the decoder's 16 KiB history, built
    in device memory, then batches in the history whose sources only
    device memory holds); matches of offset 1, 2 and 3 under lengths of
    257 to 20,000 (in the history and past it); a batch whose matches read
    the matches of the same batch, each starting inside the last one's
    output; one literal run of 40,000 bytes."""
    rng = np.random.default_rng(seed)
    lit = lambda k: rng.integers(0, 256, k, np.uint8).tobytes()  # noqa: E731
    far = [(65535, 0, 0)] + [(1, 4, 1)] * 31 + [(2, 10, 65535)] * 70
    over = [(3, 300, 1), (2, 1000, 2), (5, 257, 3), (1, 20000, 3),
            (4, 9, 4), (0, 600, 2)]
    chain = [(8, 8, 8)] + [(1, 12, 9 + (k % 5)) for k in range(90)]
    streams = [lz4p_stream(far, lit(65535 + 31 + 140)),
               lz4p_stream(over, lit(15)), lz4p_stream(chain, lit(98)),
               lz4p_stream([(40000, 0, 0)], lit(40000))]
    return [(st, lz4p_serial(st)) for st in streams]


def pack_edge_rows(seed: int):
    """(comp, clens, n) on the card for the pack's batch parse: the LZ4
    streams (lz4_encode.cu at hash_log 16) of 4 text rows of 16 KiB, whose
    batches cross the staged tiles, and of 2 rows of 64 KiB of random runs
    of 300-1,500 bytes between runs of zeros (literal and match extensions
    of 2 to 6 bytes; asserted), laid in a tensor of an odd width so that
    each row starts at another skew from 16 bytes.  (The plain pack takes
    a step a sequence: 16 KiB of text keeps it to about 1,700.)"""
    n = BLOCK
    rng = np.random.default_rng(seed)
    text = np.frombuffer(text_corpus(4 * n, seed), np.uint8).reshape(4, n)
    runs = np.zeros((2, n), np.uint8)
    for r in range(2):
        at = 0
        while at < n:
            k = int(rng.integers(300, 1500))
            runs[r, at : at + k] = rng.integers(0, 256, min(k, n - at),
                                                np.uint8)
            at += k + int(rng.integers(300, 1500))
    x = torch.from_numpy(np.concatenate([text, runs])).cuda()
    xl = torch.tensor([n // 4] * 4 + [n] * 2, dtype=torch.int32,
                      device="cuda")
    comp, clens = lz4_coder.lz4_encode_batch(x, xl, 16)
    w = comp.shape[1] | 1
    odd = torch.zeros((6, w + 2), dtype=torch.uint8, device="cuda")
    odd[:, : comp.shape[1]] = comp
    seqs = lz4p_coder._lz4_sequences(comp[4:].cpu(), clens[4:].cpu())
    if int(seqs[1].max()) < 15 + 255 or int(seqs[2].max()) < 19 + 255:
        raise AssertionError("pack edge rows: no extension of 2 bytes")
    return odd, clens, n


def lz4p_check(name: str, comp, clens, n: int, split: bool) -> dict:
    """lz4p.cu's pack of LZ4 streams of blocks of n bytes, then its decode
    of the packed rows, each against its plain version, exact; the rows
    decoded back to the LZ4 streams' own decode."""
    got = lz4p_coder.lz4p_pack(comp, clens, n, split)
    ref, pack_plain_ms = timed(
        lambda: lz4p_coder.lz4p_pack_plain(comp, clens, n, split))
    rec = {"rows": list(comp.shape), "split": split,
           "olens": got[1].tolist()[:4],
           "pack_max_abs_err": max(max_err(a, c) for a, c in zip(got, ref)),
           "pack_ms": cuda_ms(lambda: lz4p_coder.lz4p_pack(
               comp, clens, n, split), 3), "pack_plain_ms": pack_plain_ms}
    ok = got[1] >= 0
    dec = lz4p_coder.lz4p_decode_batch(got[0], got[1].clamp(min=0), n)
    dref, dec_plain_ms = timed(lambda: lz4p_coder.lz4p_decode_batch_plain(
        got[0], got[1].clamp(min=0), n))
    want, wstatus = lz4_coder.lz4_decode_batch(comp, clens, n)
    back = (torch.equal(dec[1][ok], wstatus[ok])
            and torch.equal(dec[0][ok], want[ok]))
    rec.update(decode_max_abs_err=max(max_err(a, c)
                                      for a, c in zip(dec, dref)),
               decode_ms=cuda_ms(lambda: lz4p_coder.lz4p_decode_batch(
                   got[0], got[1].clamp(min=0), n), 3),
               decode_plain_ms=dec_plain_ms, round_trip=back)
    if not back:
        raise AssertionError(f"lz4p {name}: rows did not decode back")
    return rec


def lz4p_kernel_check(x, xl, n: int):
    """csrc/lz4p.cu against its plain versions, exact: the pack under the
    C++ rule (split) on lz4_encode.cu's streams of the mixed rows at
    hash_log 16, of a 64 KiB row where no 4 bytes repeat (65,535 + 1
    literals), of a 256 KiB zero row (its match in pieces of 65,535) and
    of pack_edge_rows() (batches across the staged tiles, at every skew,
    extensions of 2 bytes or more);
    under the XLA rule (unsplit) on lz4_dense.cu's streams at 15 of the
    mixed rows and of the 64 KiB row, which it refuses (length -1, fault
    7); the pack also on lz4_garbage()'s 64 streams no encoder writes
    (literals past the stream, columns past the row: length -1 both ways);
    the decoder on every packed row (each decoded back to the LZ4
    stream's bytes), on lz4p_edge_streams() (each decoded to its bytes)
    and on lz4p_garbage(), status and bytes equal to the plain version's.
    Returns (the results, each launch's max_abs_err)."""
    big = torch.from_numpy(unrepeated_row(1 << 16, SEED + 13)[None]).cuda()
    blen = torch.full((1,), 1 << 16, dtype=torch.int32, device="cuda")
    zero = torch.zeros((1, 1 << 18), dtype=torch.uint8, device="cuda")
    zlen = torch.full((1,), 1 << 18, dtype=torch.int32, device="cuda")
    res = {
        "cpp_mixed": lz4p_check("cpp_mixed", *lz4_coder.lz4_encode_batch(
            x, xl, 16), n, True),
        "xla_mixed": lz4p_check("xla_mixed", *lz4_dense.lz4_dense_encode_batch(
            x, xl, lz4_dense.HASH_LOG), n, False),
        "cpp_64KiB_unrepeated": lz4p_check(
            "cpp_64KiB", *lz4_coder.lz4_encode_batch(big, blen), 1 << 16,
            True),
        "xla_64KiB_unrepeated": lz4p_check(
            "xla_64KiB", *lz4_dense.lz4_dense_encode_batch(
                big, blen, lz4_dense.HASH_LOG), 1 << 16, False),
        "cpp_256KiB_zero": lz4p_check(
            "cpp_zero", *lz4_coder.lz4_encode_batch(zero, zlen), 1 << 18,
            True)}
    res["cpp_edges"] = lz4p_check("edges", *pack_edge_rows(SEED + 16), True)
    if res["cpp_64KiB_unrepeated"]["olens"] != [65556] or \
            res["xla_64KiB_unrepeated"]["olens"] != [-1]:
        raise AssertionError(f"lz4p pack of the 64 KiB row: {res}")
    bad, blens = padded(lz4_garbage(2200, SEED + 15), 2200)
    res["lz4_garbage"] = {"rows": int(bad.shape[0])}
    for split in (True, False):
        got = lz4p_coder.lz4p_pack(bad, blens, 2048, split)
        ref = lz4p_coder.lz4p_pack_plain(bad, blens, 2048, split)
        res["lz4_garbage"][f"split_{split}"] = {
            "pack_max_abs_err": max(max_err(a, c) for a, c in zip(got, ref)),
            "refused": int((got[1] < 0).sum())}
    res["lz4_garbage"]["pack_max_abs_err"] = max(
        r["pack_max_abs_err"] for k, r in res["lz4_garbage"].items()
        if k.startswith("split"))
    edges = lz4p_edge_streams(SEED + 22)
    e, elens = padded([st for st, _ in edges], max(len(st) for st, _ in edges))
    got = lz4p_coder.lz4p_decode_batch(e, elens, 1 << 17)
    ref, plain_ms = timed(lambda: lz4p_coder.lz4p_decode_batch_plain(
        e, elens, 1 << 17))
    res["edges"] = {"rows": list(e.shape), "statuses": got[1].tolist(),
                    "decode_max_abs_err": max(max_err(a, c)
                                              for a, c in zip(got, ref)),
                    "decode_ms": cuda_ms(lambda: lz4p_coder.lz4p_decode_batch(
                        e, elens, 1 << 17), 3), "decode_plain_ms": plain_ms}
    if got[1].tolist() != [len(raw) for _, raw in edges] or not all(
            got[0][r, : len(raw)].cpu().numpy().tobytes() == raw
            for r, (_, raw) in enumerate(edges)):
        raise AssertionError(f"lz4p.cu did not decode the edge streams to "
                             f"their bytes: {res['edges']}")
    garbage = lz4p_garbage(SEED + 14)
    g, glens = padded(garbage, max(map(len, garbage)))
    got = lz4p_coder.lz4p_decode_batch(g, glens, 512)
    ref = lz4p_coder.lz4p_decode_batch_plain(g, glens, 512)
    status = got[1].tolist()
    res["garbage"] = {"rows": len(garbage),
                      "max_abs_err": max(max_err(a, c)
                                         for a, c in zip(got, ref)),
                      "valid": sum(st > 0 for st in status),
                      "refused": status.count(-1)}
    errs = {"lz4p_pack": max(r["pack_max_abs_err"] for r in res.values()
                             if "pack_max_abs_err" in r),
            "lz4p_decode": max(max(r["decode_max_abs_err"]
                                   for r in res.values()
                                   if "decode_max_abs_err" in r),
                               res["garbage"]["max_abs_err"])}
    if any(errs.values()) or not res["garbage"]["valid"] or \
            not res["garbage"]["refused"]:
        raise AssertionError(f"lz4p disagrees with its plain version, or the "
                             f"garbage rows missed a status: {res}")
    return res, errs


def lz4_route(x: torch.Tensor, hash_log: int) -> str:
    """Where lz4_encode.cu keeps its tables for rows x at hash_log: one a
    row in device memory, or a pool of fewer."""
    b = x.shape[0]
    ntab = lz4_coder.table_count(b, lz4_coder.resolve_hash_log(hash_log))
    return "device" if ntab == b else "pool"


def lz4_route_check(x, xl, n: int) -> dict:
    """lz4_encode.cu on what the mixed rows at HASH_LOGS do not reach,
    exact against the plain version: the pool (hash_log 20 on those rows
    and 128 more mixed ones, past POOL_BYTES), and far_rows() at hash_log
    12, 16 and 20, whose streams hold offsets of exactly 65,533 to 65,535
    and none of 65,536 and 65,537 (the rows with such repeats take 3000
    bytes more).  Both routes must be reached."""
    more, mlens = mixed_blocks(128, n, SEED + 7)
    far, flens = (torch.from_numpy(a).cuda() for a in far_rows(SEED + 9))
    sets = {"pool": (torch.cat([x, torch.from_numpy(more).cuda()]),
                     torch.cat([xl, torch.from_numpy(mlens).cuda()]), (20,)),
            "device": (far, flens, (12, 16, 20))}
    res, err, routes = {}, 0, set()
    for want, (rows, lens, hls) in sets.items():
        for hl in hls:
            got = lz4_coder.lz4_encode_batch(rows, lens, hl)
            ref, plain_ms = timed(
                lambda: lz4_coder.lz4_encode_batch_plain(rows, lens, hl))
            e = max(max_err(a, c) for a, c in zip(got, ref))
            err = max(err, e)
            route = lz4_route(rows, hl)
            if route != want:
                raise AssertionError(f"lz4 rows {tuple(rows.shape)} at "
                                     f"hash_log {hl} took the {route} "
                                     f"route, not the {want} one")
            routes.add(route)
            rec = {"rows": list(rows.shape), "route": route,
                   "max_abs_err": e, "plain_ms": plain_ms,
                   "ms": cuda_ms(lambda: lz4_coder.lz4_encode_batch(
                       rows, lens, hl), 3)}
            if want == "device":
                comp, clens = (a.cpu() for a in got)
                streams = [comp[r, : int(clens[r])].numpy().tobytes()
                           for r in range(len(clens))]
                offs = [lz4_offsets(st) for st in streams]
                rec["stream_bytes"] = [len(st) for st in streams]
                rec["max_offset"] = [max(o, default=0) for o in offs]
                near = [g for g, o in zip(FAR_GAPS, offs) if g in o]
                short = [len(st) < 5000 for st in streams[:len(FAR_GAPS)]]
                if near != [g for g in FAR_GAPS if g <= 0xFFFF] or short != [
                        g <= 0xFFFF for g in FAR_GAPS]:
                    raise AssertionError(f"lz4 at hash_log {hl}: repeats "
                                         f"near the offset bound taken or "
                                         f"refused wrong: {rec}")
            res[f"{want}_hash_log_{hl}"] = rec
    res["max_abs_err"] = err
    res["routes"] = sorted(routes)
    if routes | {lz4_route(x, hl) for hl in HASH_LOGS} != {"device", "pool"}:
        raise AssertionError(f"lz4_encode.cu's table routes not all "
                             f"reached: {res}")
    return res


def rle_long_check(x, xl, n: int) -> dict:
    """rle.cu's encoder on rle_long_rows() and on the mixed rows cut to
    n - 3 bytes (not 16-byte aligned), exact against the plain version,
    and the long rows decoded back by the kernel, also exact."""
    rows, lens = (torch.from_numpy(a).cuda() for a in rle_long_rows())
    res, err = {}, 0
    for name, r, rl in (("long", rows, lens),
                        ("unaligned", x[:, : n - 3].contiguous(),
                         xl.clamp(max=n - 3))):
        got = rle_coder.rle_encode_batch(r, rl)
        ref, plain_ms = timed(lambda: rle_coder.rle_encode_batch_plain(r, rl))
        e = max(max_err(a, c) for a, c in zip(got, ref))
        err = max(err, e)
        res[name] = {"rows": list(r.shape), "max_abs_err": e,
                     "plain_ms": plain_ms,
                     "stream_bytes": got[1].tolist() if name == "long"
                     else int(got[1].sum())}
    comp, clens = rle_coder.rle_encode_batch(rows, lens)
    dec = rle_coder.rle_decode_batch(comp, clens, BLOCK)
    dref = rle_coder.rle_decode_batch_plain(comp, clens, BLOCK)
    keep = torch.arange(BLOCK, device="cuda")[None, :] < lens[:, None]
    back = (torch.equal(dec[1], lens.to(torch.int64))
            and torch.equal(torch.where(keep, dec[0], 0), rows))
    res["decode_max_abs_err"] = max(max_err(a, c) for a, c in zip(dec, dref))
    res["round_trip"] = back
    res["max_abs_err"] = err
    if err or res["decode_max_abs_err"] or not back:
        raise AssertionError(f"rle on the long rows: kernel and plain "
                             f"version disagree, or a row decoded wrong: "
                             f"{res}")
    return res


def lz4_sequence(lits: bytes, off: int = 0, ml: int = 0) -> bytes:
    """One LZ4 sequence: its token, its literal run's extension, the
    literals and, where ml (4 or more) is given, the offset and the match
    length's extension; without ml, a stream's last sequence."""
    def ext(v: int) -> bytes:
        return b"" if v < 15 else b"\xff" * ((v - 15) // 255) + bytes(
            [(v - 15) % 255])

    m = ml - 4 if ml else 0
    out = bytes([min(len(lits), 15) << 4 | min(m, 15)]) + ext(len(lits))
    out += lits
    return out + (bytes([off & 255, off >> 8]) + ext(m) if ml else b"")


def lz4_long_ext_streams(seed: int) -> list:
    """(stream, decoded length or -1) of LZ4 streams whose length extensions
    run for 300 bytes across the ends of lz4_decode.cu's staged tiles
    (lz4_coder.DECODE_TILE) and of its ring of 4 tiles: a match of about
    76,500 bytes, or a literal run as long, after a first sequence sized so
    that the extension starts 1, 2 or 7 bytes before the end; and a literal
    extension that runs to the stream's end (-1)."""
    rng = np.random.default_rng(seed)
    tile = lz4_coder.DECODE_TILE
    out = []
    for end in (tile, 2 * tile, 4 * tile):
        for back in (1, 2, 7):
            long = 4 + 15 + 255 * 299 + int(rng.integers(0, 250))
            # the extension follows the second sequence's token, literal
            # and offset (match) or its token alone (literal run)
            for kind, before in (("match", 4), ("literal", 1)):
                size = end - back - before
                k = next(k for k in range(size - 3, 0, -1)
                         if len(lz4_sequence(bytes(k), 1, 4)) == size)
                head = lz4_sequence(
                    rng.integers(1, 256, k).astype(np.uint8).tobytes(), 1, 4)
                if kind == "match":
                    out.append((head + lz4_sequence(b"q", 1, long)
                                + lz4_sequence(b"end"), k + 4 + 1 + long + 3))
                else:
                    out.append((head + lz4_sequence(rng.integers(
                        0, 256, long).astype(np.uint8).tobytes()),
                        k + 4 + long))
    out.append((lz4_sequence(bytes(3000), 1, 4) + b"\xf0" + b"\xff" * 600,
                -1))
    return out


def lz4_garbage(width: int, seed: int) -> list:
    """64 garbage LZ4 streams of at most `width` bytes: 32 of random bytes,
    of random lengths; 32 valid streams of 2048 bytes of text with 1 to 4
    bytes changed, cut at a random place, or both."""
    rng = np.random.default_rng(seed)
    text = text_corpus(1 << 16, seed)
    out = [rng.integers(0, 256, rng.integers(1, width + 1)).astype(
        np.uint8).tobytes() for _ in range(32)]
    for j in range(32):
        at = int(rng.integers(0, len(text) - 2048))
        st = bytearray(olz4.compress_block(text[at : at + 2048]))
        if j % 3 != 1:
            for p in rng.integers(0, len(st), rng.integers(1, 5)):
                st[p] = int(rng.integers(0, 256))
        if j % 3 != 0:
            st = st[: rng.integers(1, len(st))]
        out.append(bytes(st))
    return out


def rle_segments(block: bytes) -> bytes:
    """tpuzip's XLA rle form of a block (tpuzip/codecs/rle.py:23-70): each
    run cut into segments of at most 256 bytes, a segment of L >= 2 bytes
    written as b b (L - 2), one of 1 byte as b."""
    out = bytearray()
    for v, r in zip(*orle.runs_of(block)):
        for cut in range(0, int(r), 256):
            seg = min(256, int(r) - cut)
            out += bytes([v]) if seg == 1 else bytes([v, v, seg - 2])
    return bytes(out)


def rle_decode_model(stream: bytes, out_cap: int):
    """The 3-state rule of csrc/rle.cu's decoder on one stream: (decoded
    bytes, or b"" where the status is -1; the status; each stream byte's
    output bytes).  S0 is a literal with pairing disarmed, S1 a literal
    armed by the literal before it, S2 a count byte: S0 -> S1; S1 -> S2 if
    the byte equals the one before it, else S1; S2 -> S2 on a 255, else S0.
    A literal writes itself, a count byte its value in copies of the last
    literal before it.  The state before each byte comes from a doubling
    scan of the bytes' maps (3 states before to 3 after), as the kernel's
    block scan takes it."""
    x = np.frombuffer(stream, np.uint8).astype(np.int64)
    n = x.size
    prev = np.concatenate([[-1], x[:-1]])
    pre = np.stack([np.ones(n, np.int64), np.where(x == prev, 2, 1),
                    np.where(x == 255, 2, 0)], 1)
    d = 1
    while d < n:
        pre[d:] = np.take_along_axis(pre[d:], pre[:-d], 1)
        d *= 2
    state = np.concatenate([[0], pre[:-1, 0]]) if n else np.zeros(0, int)
    count = state == 2
    sizes = np.where(count, x, 1)
    total = int(sizes.sum())
    if (n and pre[-1, 0] == 2) or total > out_cap:
        return b"", -1, sizes
    last = np.maximum.accumulate(np.where(count, -1, np.arange(n)))
    val = np.where(count, x[np.maximum(last, 0)], x)
    return np.repeat(val, sizes).astype(np.uint8).tobytes(), total, sizes


def rle_garbage(seed: int) -> list:
    """64 garbage rle streams of at most 8192 bytes: 16 of random bytes, 16
    of random bytes from {0, 1, 255}, 16 valid streams cut at a random
    place, and 16 of single bytes with a pair and a chain of 255s across a
    thread's (16-byte), a warp's (512-byte) or a tile's (4096-byte) end of
    csrc/rle.cu's decoder, some cut inside the chain."""
    rng = np.random.default_rng(seed)
    text = text_corpus(1 << 16, seed)
    out = [rng.integers(0, 256, rng.integers(1, 8193)).astype(
        np.uint8).tobytes() for _ in range(16)]
    out += [rng.choice(np.array([0, 1, 255], np.uint8),
                       rng.integers(1, 8193)).tobytes() for _ in range(16)]
    for _ in range(16):
        at = int(rng.integers(0, len(text) - 8192))
        block = bytearray(text[at : at + 6000])
        for r in range(0, 6000, 700):
            block[r : r + int(rng.integers(2, 600))] = bytes(
                [int(rng.integers(0, 256))]) * 600
        st = orle.encode(bytes(block[:6000]))
        out.append(st[: rng.integers(1, len(st))])
    singles = np.resize(np.arange(1, 255, dtype=np.uint8), 8192)
    for j, (end, back) in enumerate([(e, b) for e in (16, 512, 4096)
                                     for b in (1, 2, 3, 9)] + [(4096, 0)] * 4):
        chain = b"\xff" * int(rng.integers(1, 20)) + bytes(
            [int(rng.integers(0, 255))])
        st = singles[: end - back].tobytes() + b"\x00\x00" + chain
        st += singles[:100].tobytes()
        out.append(st[: end + int(rng.integers(1, 8))] if j >= 12 else st)
    return out


def decode_against_plain(codec: str, streams: list, out_cap: int) -> dict:
    """The codec's decoder kernel and its plain version on `streams`, one a
    row of a tensor 16 bytes wider than the longest, at `out_cap`: the
    kernel's bytes and statuses, and the error between the two."""
    coder = LZ[codec][0]
    width = -(-max(map(len, streams)) // 16) * 16 + 16
    comp, clens = padded(streams, width)
    dec = getattr(coder, f"{codec}_decode_batch")(comp, clens, out_cap)
    ref, plain_ms = timed(lambda: getattr(
        coder, f"{codec}_decode_batch_plain")(comp, clens, out_cap))
    return {"out": dec[0], "status": dec[1].tolist(),
            "max_abs_err": max(max_err(a, c) for a, c in zip(dec, ref)),
            "rows": [len(streams), width], "plain_ms": plain_ms}


def lz_decode_edges(n: int):
    """Both decoders, exact against their plain versions (bytes and
    statuses), on the streams that the paths and the rows above do not
    feed them: lz4 far_rows() encoded at hash_log 12, 16 and 20 and
    lz4_long_ext_streams(), at out_cap 128 KiB, and lz4_garbage() at n;
    rle_long_rows() in tpuzip's XLA segment form (rle_segments) and
    rle_garbage() at 64 KiB; and one row of each codec at an out_cap well
    under its decoded length (status -1, the row all 0).  The valid rows
    decode back to their input, and rle_decode's two write routes (a
    tile's output staged in shared memory, or past rle_coder.DECODE_STAGE
    written directly) are both reached."""
    far, flens = (torch.from_numpy(a).cuda() for a in far_rows(SEED + 9))
    far_streams = []
    for hl in (12, 16, 20):
        comp, clens = (a.cpu() for a in lz4_coder.lz4_encode_batch(
            far, flens, hl))
        far_streams += [comp[r, : int(clens[r])].numpy().tobytes()
                        for r in range(len(clens))]
    longs = lz4_long_ext_streams(SEED + 10)
    long_rows, long_sizes = zip(*longs)
    seg_in, seg_lens = rle_long_rows()
    segs = [rle_segments(seg_in[r, : seg_lens[r]].tobytes())
            for r in range(len(seg_in))]
    sets = {
        "lz4_far_and_long_ext": ("lz4", far_streams + list(long_rows),
                                 FAR_BLOCK),
        "lz4_garbage": ("lz4", lz4_garbage(n + 24, SEED + 11), n),
        "lz4_out_cap": ("lz4", far_streams[:1], 1000),
        "rle_segments_and_garbage": ("rle", segs + rle_garbage(SEED + 12),
                                     BLOCK),
        "rle_out_cap": ("rle", segs[:1], 1000)}
    res, errs = {}, {"lz4_decode": 0, "rle_decode": 0}
    for name, (codec, streams, out_cap) in sets.items():
        got = decode_against_plain(codec, streams, out_cap)
        status = got["status"]
        errs[f"{codec}_decode"] = max(errs[f"{codec}_decode"],
                                      got["max_abs_err"])
        res[name] = {k: got[k] for k in ("rows", "max_abs_err", "plain_ms")}
        res[name]["failed_rows"] = sum(s < 0 for s in status)
        if name.endswith("out_cap"):
            want = {r: (b"", -1) for r in range(len(streams))}
        elif name == "lz4_far_and_long_ext":
            want = {r: (far[r % len(far)].cpu().numpy().tobytes(),
                        FAR_BLOCK) for r in range(len(far_streams))}
            want.update({len(far_streams) + r: (None, s)
                         for r, s in enumerate(long_sizes)})
        elif codec == "rle":
            want = {r: (seg_in[r, : seg_lens[r]].tobytes(), int(seg_lens[r]))
                    for r in range(len(segs))}
        else:
            want = {}
        for r, (data, size) in want.items():
            row = got["out"][r].cpu().numpy().tobytes()
            if status[r] != size or (data is not None and (
                    row[: max(size, 0)] != data
                    or any(row[max(size, 0):]))):
                raise AssertionError(f"{name} row {r}: status {status[r]}, "
                                     f"expected {size}, or wrong bytes")
        if codec == "rle":
            tiles = []
            for st, s in zip(streams, status):
                if s >= 0 and st:
                    sizes = rle_decode_model(st, out_cap)[2]
                    tiles += np.add.reduceat(sizes, np.arange(
                        0, len(st), rle_coder.DECODE_TILE)).tolist()
            res[name]["tiles_staged"] = sum(
                t <= rle_coder.DECODE_STAGE for t in tiles)
            res[name]["tiles_direct"] = len(tiles) - res[name]["tiles_staged"]
    if errs["lz4_decode"] or errs["rle_decode"]:
        raise AssertionError(f"a decoder disagrees with its plain version "
                             f"on the edge rows: {res}")
    seg = res["rle_segments_and_garbage"]
    if not (seg["tiles_staged"] and seg["tiles_direct"]):
        raise AssertionError(f"rle_decode's write routes not both reached: "
                             f"{seg}")
    return res, errs


def payloads(blob: bytes, head: int):
    """(head bytes, chunk index, stream) of every block of a container with
    flag 2, parsed here so the check does not lean on the code under
    test; head is 0 for ari and 4 (the origin) for bwt."""
    flags = blob[5]
    nb = struct.unpack_from("<I", blob, 10)[0]
    clens = np.frombuffer(blob, "<u4", nb, 26)
    off = 26 + 4 * nb + (4 * nb if flags & 1 else 0) + (6 if flags & 4 else 0)
    out = []
    for n in clens:
        (idxlen,) = struct.unpack_from("<I", blob, off + head)
        p = off + head + 4
        out.append((blob[off : off + head], blob[p : p + idxlen],
                    blob[p + idxlen : off + int(n)]))
        off += int(n)
    return out


def strip_index(blob: bytes) -> bytes:
    """A container with flag 2 as tpuzip writes it without the chunk index
    (its run_job): flag 2 cleared, [u32 idx_len][idx] cut from each
    payload, the length table rewritten.  Parsed here, so the check does
    not lean on the code under test; not for flag 8."""
    codec, flags = blob[4], blob[5]
    if not flags & 2 or flags & 8:
        raise ValueError(f"flags {flags}: not an indexed flat container")
    head = {4: 4, 6: 8}.get(codec, 0)    # bwt: origin; bwtdc: + dc_len
    nb = struct.unpack_from("<I", blob, 10)[0]
    clens = np.frombuffer(blob, "<u4", nb, 26)
    tables = 26 + 4 * nb
    off = tables + (4 * nb if flags & 1 else 0) + (6 if flags & 4 else 0)
    parts = []
    for n in clens:
        p = blob[off : off + int(n)]
        (idxlen,) = struct.unpack_from("<I", p, head)
        parts.append(p[:head] + p[head + 4 + idxlen:])
        off += int(n)
    lens = np.array([len(p) for p in parts], "<u4").tobytes()
    return (blob[:5] + bytes([flags & ~2]) + blob[6:26] + lens
            + blob[tables : tables + (4 * nb if flags & 1 else 0)
                   + (6 if flags & 4 else 0)] + b"".join(parts))


def traced(fn, expect=()) -> dict:
    """One more run of fn under torch.profiler: wall time, the time of the
    device's own events (kernels and copies; host ops that launched them and
    the profiler's buffer requests left out), the ones that took most, and
    the device ms of each kernel of `expect` (a name fragment), and the
    name of every kernel traced (kernel_name).  `missing` lists each kernel
    of `expect` that fn launches but the trace lacks: the device time and
    idle share are then null, as they would be too low and too high."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or e.key.startswith("Activity Buffer")):
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, e.key))
    rows.sort(reverse=True)
    missing = [k for k in expect if not any(k in name for _, name in rows)]
    device_ms = None if missing else sum(ms for ms, _ in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": None if missing else 1 - device_ms / wall_ms,
            "top": [[name[:80], ms] for ms, name in rows[:6]],
            "expected_ms": {k: sum(ms for ms, name in rows if k in name)
                            for k in expect}, "missing": missing,
            "kernels": sorted({kernel_name(name)[:80] for _, name in rows})}


def kernel_name(key: str) -> str:
    """A device event's kernel as its source names it, from the profiler's
    demangled key: `void (anonymous namespace)::k<(anonymous
    namespace)::A<B> >(int const*, int)` -> `k<A<B>>`."""
    name = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.replace(" >", ">")


def host_profile(fn, top: int = 10) -> list:
    """One more run of fn under cProfile: the functions that took most of
    the host's time themselves (tottime, ms; the profiler's own cost is in
    them).  A wait for the device shows as the call that blocked."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(((tt * 1e3, f"{f.rsplit('/', 1)[-1]}:{line}({name})")
                   for (f, line, name), (_, _, tt, _, _)
                   in pstats.Stats(prof).stats.items()), reverse=True)
    return [[name, ms] for ms, name in rows[:top]]


@contextlib.contextmanager
def recorded(module, name: str):
    """Keep the arguments and result of every call of module.name (a kernel
    wrapper) while the block runs; the wrapper itself is untouched.  The
    wrapper adds to the `launches` of whatever module.name holds, so the
    stand-in carries the count meanwhile and hands it back."""
    real = getattr(module, name)
    calls = []

    def keep(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    keep.launches = real.launches
    setattr(module, name, keep)
    try:
        yield calls
    finally:
        real.launches = keep.launches
        setattr(module, name, real)


WRAPPERS = {"ari_encode": (range_coder, "ari_encode_indexed"),
            "ari_decode": (range_decoder, "ari_decode_indexed"),
            "ari_decode_dot": (range_decoder, "ari_decode_dot_indexed"),
            "mtf": (mtf_scan, "mtf_batch"),
            "dc_decode": (dc_scan, "dc_decode_lanes"),
            "bin_encode": (bin_coder, "bin_encode_indexed"),
            "bin_decode": (bin_coder, "bin_decode_indexed"),
            "lz4_encode": (lz4_coder, "lz4_encode_batch"),
            "lz4_decode": (lz4_coder, "lz4_decode_batch"),
            "rle_encode": (rle_coder, "rle_encode_batch"),
            "rle_decode": (rle_coder, "rle_decode_batch"),
            "lz4_links_tiled": (lz4_links, "lz4_links_tiled"),
            "lz4_links_sorted": (lz4_links, "lz4_links_sorted"),
            "lz4_dense_words": (lz4_dense, "lz4_dense_words"),
            "lz4_dense_words_links": (lz4_dense, "lz4_dense_words_links"),
            "lz4_dense_words_parse": (lz4_dense, "lz4_dense_words_parse"),
            "rle_encode_seg": (rle_coder, "rle_encode_segments_batch"),
            "lz4_chain_links": (lz4_chain, "lz4_chain_links"),
            "lz4_chain_best": (lz4_chain, "lz4_chain_best"),
            "lz4_chain_parse": (lz4_chain, "lz4_chain_parse"),
            "lz4p_pack": (lz4p_coder, "lz4p_pack"),
            "lz4p_decode": (lz4p_coder, "lz4p_decode_batch"),
            "deflate_links": (deflate_coder, "deflate_links_tiled"),
            "deflate_links_shared": (deflate_coder, "deflate_links_shared"),
            "deflate_parse": (deflate_coder, "deflate_parse"),
            "deflate_emit": (deflate_coder, "deflate_emit"),
            "deflate_parse_greedy": (deflate_coder, "deflate_parse_greedy"),
            "deflate_emit_tuple": (deflate_coder, "deflate_emit_tuple"),
            "inflate": (deflate_coder, "inflate_batch"),
            # the modes the streams phase adds: the linked LZ4 frame's
            # history, the zlib writer's fragments, the zlib reader's ends
            "lz4_decode_history": (lz4_coder, "lz4_decode_history"),
            "deflate_emit_fragment": (deflate_coder,
                                      "deflate_emit_fragment"),
            "inflate_ends": (deflate_coder, "inflate_ends"),
            "xxh32_batch": (kxxh32, "xxh32_batch"),
            "xxh32_stripes": (kxxh32, "xxh32_stripes"),
            # the same two kernels in their modes without the chunk index
            "ari_decode_unindexed": (range_decoder, "decode_batch"),
            "bin_decode_unindexed": (bin_apm, "decode_batch")}
PLAINS = ((range_coder, "ari_encode_indexed_plain"),
          (range_decoder, "ari_decode_indexed_plain"),
          (range_decoder, "decode_batch_plain"),
          (range_decoder, "ari_decode_dot_indexed_plain"),
          (mtf_scan, "mtf_batch_plain"),
          (dc_scan, "dc_decode_lanes_plain"),
          (bin_coder, "bin_encode_indexed_plain"),
          (bin_coder, "bin_decode_indexed_plain"),
          (lz4_coder, "lz4_encode_batch_plain"),
          (lz4_coder, "lz4_decode_batch_plain"),
          (rle_coder, "rle_encode_batch_plain"),
          (rle_coder, "rle_decode_batch_plain"),
          (lz4_dense, "lz4_dense_candidates_plain"),
          (lz4_dense, "lz4_dense_parse_plain"),
          (lz4_dense, "lz4_dense_words_plain"),
          (lz4_dense, "lz4_dense_words_links_plain"),
          (lz4_links, "lz4_links_plain"),
          (lz4_dense, "lz4_dense_words_parse_plain"),
          (rle_coder, "rle_encode_segments_batch_plain"),
          (lz4_chain, "lz4_chain_links_plain"),
          (lz4_chain, "lz4_chain_best_plain"),
          (lz4_chain, "lz4_chain_parse_plain"),
          (lz4p_coder, "lz4p_pack_plain"),
          (lz4p_coder, "lz4p_decode_batch_plain"),
          (deflate_coder, "deflate_links_plain"),
          (deflate_coder, "deflate_parse_plain"),
          (deflate_coder, "deflate_emit_plain"),
          (deflate_coder, "inflate_batch_plain"),
          (kxxh32, "xxh32_batch_plain"),
          (kxxh32, "xxh32_stripes_plain"))


@contextlib.contextmanager
def refused(module, name: str):
    """module.name (a plain version) raises while the block runs: on the
    card the main path must launch kernels, never fall back to it."""
    real = getattr(module, name)

    def refuse(*args, **kw):
        raise AssertionError(f"{name} ran on the main path")

    setattr(module, name, refuse)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def counted_run():
    """Record every kernel wrapper's calls while the block runs, with every
    launch count set to 0 just before, and refuse every plain version.
    Yields ({kernel: calls}, counts); counts is filled with each launch
    count read just after the block."""
    counts = {}
    with contextlib.ExitStack() as stack:
        calls = {k: stack.enter_context(recorded(mod, name))
                 for k, (mod, name) in WRAPPERS.items()}
        for mod, name in PLAINS:
            stack.enter_context(refused(mod, name))
        torch.cuda.synchronize()
        for mod, name in WRAPPERS.values():
            getattr(mod, name).launches = 0
        yield calls, counts
        torch.cuda.synchronize()
        counts.update({k: getattr(mod, name).launches
                       for k, (mod, name) in WRAPPERS.items()})


def ari_bound(kind: str, args, out) -> dict:
    """bound() of one ari launch at its own inputs: the valid symbols, the
    stream bytes the coder produces or consumes, the lengths and the chunk
    index."""
    if kind == "ari_encode":
        blocks, lens = args[:2]
        streams, slens, deltas = out
        nbytes = (int(lens.sum()) + 4 * lens.numel() + int(slens.sum())
                  + 4 * slens.numel() + 4 * deltas.numel())
    else:
        streams, deltas, lens = args[:3]
        nbytes = (int(deltas.sum()) + 4 * deltas.shape[0]
                  + 4 * deltas.numel() + 4 * lens.numel() + out.numel())
    return bound(nbytes)


def mtf_against_plain(calls, cols: int) -> dict:
    """Each MTF launch of a path held, exact, against the plain version on
    the same CUDA tensors cut to their first `cols` columns (MTF is causal:
    the kernel's first cols outputs are the plain version's on the cut),
    and the kernel on the cut (its rows end inside a chunk, mtf_cut())
    against the same; the kernel's time at the full shape and at the cut,
    the plain version's at the cut, and the bound at the full shape: the
    valid bytes read and the rows written."""
    res = {}
    for args, kw, out in calls:
        blocks, lens = args
        decode = kw.get("decode", False)
        name = "mtf_decode" if decode else "mtf_encode"
        if name in res:
            raise AssertionError(f"{name} launched twice on one path")
        cut = blocks[:, :cols].contiguous()
        cut_lens = lens.clamp(max=cols)
        ref, plain_ms = timed(
            lambda: mtf_scan.mtf_batch_plain(cut, cut_lens, decode))
        err = max(max_err(out[:, :cols], ref),
                  max_err(mtf_scan.mtf_batch(cut, cut_lens, decode), ref))
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the path's inputs: max_abs_err {err}")
        res[name] = {
            "inputs": list(blocks.shape), "plain_inputs": list(cut.shape),
            "max_abs_err": err,
            "ms": cuda_ms(lambda: mtf_scan.mtf_batch(blocks, lens,
                                                     decode=decode), 3),
            "ms_at_plain_inputs": cuda_ms(
                lambda: mtf_scan.mtf_batch(cut, cut_lens, decode=decode), 3),
            "plain_ms": plain_ms,
            **bound(int(lens.sum()) + 4 * lens.numel() + out.numel())}
    if set(res) != {"mtf_encode", "mtf_decode"}:
        raise AssertionError(f"MTF ran {sorted(res)} on the path, expected "
                             "both directions")
    return res


def ari_prefix_against_plain(calls, cols: int) -> dict:
    """A path's one launch of each ari kernel held, exact, against the
    plain version on the same CUDA tensors cut to their first `cols`
    symbols (the coder is causal and its renormalisation carryless, so a
    byte once written never changes).  Encode: the cut's chunk index equals
    the kernel's first cols/64 entries, and its stream the kernel's, up to
    the cut's 4 finish bytes on the rows it shortens and whole (length
    included) on the others.  Decode: the plain version on the kernel's own
    stream rows, with the index and the lengths cut, gives the kernel's
    first cols symbols.  Times of each kernel at the path's shape and at
    the cut, of the plain version at the cut; the bound at the path's
    shape."""
    res = {}
    for name in ("ari_encode", "ari_decode"):
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} launches on "
                                 "the path, expected 1")
    (args, kw, out), = calls["ari_encode"]
    syms, lens = args[:2]
    cut, cut_lens = syms[:, :cols].contiguous(), lens.clamp(max=cols)
    ref, plain_ms = timed(lambda: range_coder.ari_encode_indexed_plain(
        cut, cut_lens, *args[2:], **kw))
    streams, slens, deltas = out
    ref_streams, ref_slens, ref_deltas = ref
    whole = lens <= cols                   # rows the cut leaves whole
    agree = ref_slens.to(torch.int64) - 4 * (~whole)
    w = ref_streams.shape[1]
    keep = torch.arange(w, device=syms.device)[None, :] < agree[:, None]
    err = max(max_err(deltas[:, : ref_deltas.shape[1]], ref_deltas),
              max_err(torch.where(keep, streams[:, :w], 0),
                      torch.where(keep, ref_streams, 0)),
              max_err(torch.where(whole, slens, 0),
                      torch.where(whole, ref_slens, 0)))
    if err:
        raise AssertionError("ari_encode disagrees with its plain version "
                             f"on the path's inputs: max_abs_err {err}")
    res["ari_encode"] = {
        "inputs": [list(a.shape) for a in args[:2]],
        "plain_inputs": list(cut.shape), "max_abs_err": err,
        "ms": cuda_ms(lambda: range_coder.ari_encode_indexed(*args, **kw), 1),
        "ms_at_plain_inputs": cuda_ms(lambda: range_coder.ari_encode_indexed(
            cut, cut_lens, *args[2:], **kw), 3),
        "plain_ms": plain_ms, **ari_bound("ari_encode", args, out)}

    (args, kw, out), = calls["ari_decode"]
    streams, deltas, lens = args[:3]
    nc = min(cols // range_decoder.CHUNK_STEPS, deltas.shape[1])
    cut_deltas = deltas[:, :nc].contiguous()
    cut_lens = lens.clamp(max=nc * range_decoder.CHUNK_STEPS)
    ref, plain_ms = timed(lambda: range_decoder.ari_decode_indexed_plain(
        streams, cut_deltas, cut_lens, *args[3:], **kw))
    err = max_err(out[:, : ref.shape[1]], ref)
    if err:
        raise AssertionError("ari_decode disagrees with its plain version "
                             f"on the path's inputs: max_abs_err {err}")
    res["ari_decode"] = {
        "inputs": [list(a.shape) for a in args[:3]],
        "plain_inputs": list(ref.shape), "max_abs_err": err,
        "ms": cuda_ms(lambda: range_decoder.ari_decode_indexed(*args, **kw),
                      1),
        "ms_at_plain_inputs": cuda_ms(
            lambda: range_decoder.ari_decode_indexed(
                streams, cut_deltas, cut_lens, *args[3:], **kw), 3),
        "plain_ms": plain_ms, **ari_bound("ari_decode", args, out)}
    return res


def round_trip(data: bytes, **kw):
    """compress + decompress on cuda under counted_run(): (container,
    calls, counts, encode s, decode s, peak device bytes of each)."""
    with counted_run() as (calls, counts):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        blob = tpuzip_torch.compress(data, device="cuda", **kw)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        peak_enc = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        back = tpuzip_torch.decompress(blob, device="cuda")
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        peak_dec = torch.cuda.max_memory_allocated()
    if back != data:
        raise AssertionError(f"{len(data)} bytes did not round-trip ({kw})")
    if counts["ari_decode_dot"]:
        raise AssertionError(f"a container path launched the dot route "
                             f"({kw})")
    # one wrapper launches both MTF directions: split its count by the
    # direction of each recorded call
    dec = sum(1 for _, kw_, _ in calls["mtf"] if kw_.get("decode"))
    if len(calls["mtf"]) != counts["mtf"]:
        raise AssertionError(f"{len(calls['mtf'])} MTF calls, "
                             f"{counts['mtf']} launches")
    counts.update(mtf_encode=counts["mtf"] - dec, mtf_decode=dec)
    return blob, calls, counts, t_enc, t_dec, peak_enc, peak_dec


def need(counts: dict, at_least: dict, path: str) -> None:
    short = {k: counts[k] for k, n in at_least.items() if counts[k] < n}
    if short:
        raise AssertionError(f"{path} path missed a kernel: {counts}, "
                             f"needs {at_least}")


def phase_main(smi: str):
    data = text_corpus(CORPUS_BYTES, SEED)
    # warm the CUDA context, allocator and host paths outside the timing
    tpuzip_torch.decompress(tpuzip_torch.compress(data[: 4 * BLOCK],
                                                  codec="ari"))
    blob, calls, launches, t_enc, t_dec, _, _ = round_trip(
        data, codec="ari", block_size=BLOCK)
    need(launches, {"ari_encode": 1, "ari_decode": 1}, "ari")

    blocks_np, lens_np = blk.chunk(data, BLOCK)
    parts = payloads(blob, 0)
    nb = len(parts)
    checked = sorted({0, 1, 2, nb // 3, nb // 2, 2 * nb // 3, nb - 2, nb - 1})
    for i in checked:
        exp = oari.encode_bytes(blocks_np[i, : lens_np[i]].tobytes())
        if parts[i][2] != exp:
            raise AssertionError(f"block {i} stream differs from the oracle")

    # each kernel against its plain version on the main path's own inputs
    # cut to their first ARI_PLAIN_COLS symbols (whole blocks are covered
    # by the oracle check above and the round trip)
    kernels = ari_prefix_against_plain(calls, ARI_PLAIN_COLS)
    decode_call = calls["ari_decode"][0]   # phase dot's input
    calls.clear()
    compress = lambda: tpuzip_torch.compress(  # noqa: E731
        data, codec="ari", block_size=BLOCK)
    decompress = lambda: tpuzip_torch.decompress(blob)           # noqa: E731
    emit("main", corpus_bytes=len(data), block_size=BLOCK, blocks=nb,
         container_bytes=len(blob), ratio=len(blob) / len(data),
         launches=launches, oracle_blocks=checked,
         encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec, kernels=kernels,
         encode_kernel_mb_s=len(data) / 1e3 / kernels["ari_encode"]["ms"],
         decode_kernel_mb_s=len(data) / 1e3 / kernels["ari_decode"]["ms"],
         trace={"encode": traced(compress, ("ari_encode_kernel",)),
                "decode": traced(decompress, ("ari_decode_kernel",))},
         host_profile={"encode": host_profile(compress),
                       "decode": host_profile(decompress)}, card=smi)
    return launches, kernels, decode_call, blob


def in_turns(args, kw, reps: int) -> dict:
    """CUDA-event ms of both ari decoders on the same inputs, taken in turns
    (cum, dot, dot, cum; each the mean of reps runs), and dot over cum."""
    cum = lambda: range_decoder.ari_decode_indexed(*args, **kw)      # noqa: E731
    dot = lambda: range_decoder.ari_decode_dot_indexed(*args, **kw)  # noqa: E731
    t = [cuda_ms(fn, reps) for fn in (cum, dot, dot, cum)]
    cum_ms, dot_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    return {"cum_ms": cum_ms, "dot_ms": dot_ms, "dot_over_cum": dot_ms / cum_ms,
            "turns_ms": t}


def ab_mix(b: int, n: int, seed: int) -> np.ndarray:
    """The input of tpuzip's decode A/B (bench/tpu_r2d.py:68-77): block i
    is random bytes if i % 3 == 0, text if 1, and 6 symbols if 2."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(text_corpus(b * n, seed), np.uint8).reshape(b, n)
    mix = np.empty((b, n), np.uint8)
    for i in range(b):
        if i % 3 == 0:
            mix[i] = rng.integers(0, 256, n)
        elif i % 3 == 1:
            mix[i] = text[i]
        else:
            mix[i] = rng.integers(0, 6, n)
    return mix


def phase_dot(smi: str, decode_call):
    """The decode A/B of tpuzip's cum and dot algos, (a) on the ari path's
    own decode launch `decode_call` and (b) on the mix of tpuzip's A/B.
    Both routes launch ari_decode.cu; the dot route's launch is counted by
    its own wrapper, and held against its plain version, tpuzip's v1 step
    on frequency state.  Returns the launch counts of (a) and the dot
    route's row at the ari path's shape."""
    args, kw, cum_out = decode_call
    streams, deltas, lens = args[:3]
    with counted_run() as (_, launches):
        out = range_decoder.ari_decode_indexed(*args, **kw, algo="dot")
    if launches != {k: int(k == "ari_decode_dot") for k in WRAPPERS}:
        raise AssertionError(f"algo='dot' launched {launches}, expected the "
                             "dot route once")
    launches.update(mtf_encode=0, mtf_decode=0)
    if not torch.equal(out, cum_out):
        raise AssertionError("the dot and cum routes disagree on the ari "
                             "path's inputs")
    # the plain version on the first ARI_PLAIN_COLS symbols, as
    # ari_prefix_against_plain cuts a decode launch
    nc = min(ARI_PLAIN_COLS // range_decoder.CHUNK_STEPS, deltas.shape[1])
    ref, plain_ms = timed(lambda: range_decoder.ari_decode_dot_indexed_plain(
        streams, deltas[:, :nc].contiguous(),
        lens.clamp(max=nc * range_decoder.CHUNK_STEPS), **kw))
    err = max_err(out[:, : ref.shape[1]], ref)
    if err:
        raise AssertionError("the dot route disagrees with its plain version "
                             f"on the ari path's inputs: max_abs_err {err}")
    main = in_turns(args, kw, 5)
    kernel = {"inputs": [list(a.shape) for a in args[:3]],
              "plain_inputs": list(ref.shape), "max_abs_err": err,
              "ms": main["dot_ms"], "plain_ms": plain_ms,
              **ari_bound("ari_decode", args, out)}

    mix = torch.from_numpy(ab_mix(128, BLOCK, SEED)).cuda()
    mix_lens = torch.full((128,), BLOCK, dtype=torch.int32, device="cuda")
    mix_streams, _, mix_deltas = range_coder.ari_encode_indexed(mix, mix_lens)
    mix_args = (mix_streams, mix_deltas, mix_lens)
    exact = {
        "cum": bool(torch.equal(range_decoder.ari_decode_indexed(*mix_args),
                                mix)),
        "dot": bool(torch.equal(
            range_decoder.ari_decode_dot_indexed(*mix_args), mix))}
    if not all(exact.values()):
        raise AssertionError(f"the A/B mix did not decode exactly: {exact}")
    ab = in_turns(mix_args, {}, 5)
    emit("dot", launches=launches, inputs=kernel["inputs"],
         kernel="tpuzip_torch/csrc/ari_decode.cu", equals_cum_route=True,
         max_abs_err=err,
         plain_inputs=kernel["plain_inputs"], plain_ms=plain_ms,
         bound_ms=kernel["bound_ms"], main=main,
         main_mb_s={k: CORPUS_BYTES / 1e3 / main[f"{k}_ms"]
                    for k in ("cum", "dot")},
         mix={"blocks": 128, "block_size": BLOCK, "exact": exact, **ab,
              "mb_s": {k: mix.numel() / 1e3 / ab[f"{k}_ms"]
                       for k in ("cum", "dot")}},
         card=smi)
    return launches, kernel


def bwt_ms(calls, blocks_np, lens_np, parts) -> dict:
    """CUDA-event milliseconds of the BWT forward and inverse on the inputs
    they had on the bwt path: many sorts and gathers and, forward, a host
    sync a round, so the trace's per-kernel rows do not add up to them."""
    blocks = torch.from_numpy(blocks_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    origins = torch.tensor([struct.unpack("<I", p[0])[0] for p in parts],
                           dtype=torch.int32, device="cuda")
    (enc_args, _, _), = [c for c in calls["mtf"] if not c[1].get("decode")]
    return {
        "bwt_forward": cuda_ms(lambda: bwt.encode_batch(blocks, lens), 2),
        "bwt_inverse": cuda_ms(
            lambda: bwt.decode_batch(enc_args[0], origins, lens), 2)}


def phase_bwt(smi: str):
    data = text_corpus(CORPUS_BYTES, SEED)
    tpuzip_torch.decompress(tpuzip_torch.compress(
        data[: 2 * BWT_BLOCK], codec="bwt", block_size=BWT_BLOCK))
    blob, calls, launches, t_enc, t_dec, peak_enc, peak_dec = round_trip(
        data, codec="bwt", block_size=BWT_BLOCK)
    need(launches, {"mtf_encode": 1, "mtf_decode": 1, "ari_encode": 1,
                    "ari_decode": 1}, "bwt")
    if blob[5] & 8 or struct.unpack_from("<I", blob, 6)[0] != BWT_BLOCK:
        raise AssertionError("bwt did not take 1 MiB blocks, flag 2")
    # traced first, before the checks below launch the plain versions: in
    # two runs the profiler lost the ari decode kernel when traced after them
    compress = lambda: tpuzip_torch.compress(  # noqa: E731
        data, codec="bwt", block_size=BWT_BLOCK)
    decompress = lambda: tpuzip_torch.decompress(blob)           # noqa: E731
    trace = {"encode": traced(compress, ("ari_encode_kernel", "mtf_last",
                                         "mtf_compose<false>",
                                         "mtf_scan<false>")),
             "decode": traced(decompress, ("ari_decode_kernel",
                                           "mtf_scan<true>",
                                           "mtf_compose<true>", "mtf_map"))}

    # L and the origins against the oracle's BWT: L is the input of the
    # path's MTF encode, the origins head each block's payload
    blocks_np, lens_np = blk.chunk(data, BWT_BLOCK)
    (enc_args, _, _), = [c for c in calls["mtf"] if not c[1].get("decode")]
    parts = payloads(blob, 4)
    nb = len(parts)
    checked = sorted({0, 1, nb // 2, nb - 1})
    for i in checked:
        exp_L, exp_origin = obwt.encode_block(
            blocks_np[i, : lens_np[i]].tobytes())
        got_L = enc_args[0][i, : lens_np[i]].cpu().numpy().tobytes()
        if got_L != exp_L or struct.unpack("<I", parts[i][0])[0] != exp_origin:
            raise AssertionError(f"bwt block {i} differs from the oracle")
    mtf = mtf_against_plain(calls["mtf"], mtf_cut(MTF_PLAIN_COLS["bwt"]))
    ari = ari_prefix_against_plain(calls, ARI_PLAIN_COLS)
    stages = bwt_ms(calls, blocks_np, lens_np, parts)
    calls.clear()
    emit("bwt", corpus_bytes=len(data), block_size=BWT_BLOCK, blocks=nb,
         container_bytes=len(blob), ratio=len(blob) / len(data),
         launches=launches, oracle_blocks=checked,
         encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec,
         peak_device_bytes={"encode": peak_enc, "decode": peak_dec},
         mtf=mtf, ari=ari, bwt_ms=stages, trace=trace,
         host_profile={"encode": host_profile(compress),
                       "decode": host_profile(decompress)}, card=smi)
    return launches, {**mtf, **ari}


def phase_bwt_big(smi: str):
    data = text_corpus(BIG_BLOCK, SEED)
    blob, calls, launches, t_enc, t_dec, peak_enc, peak_dec = round_trip(
        data, codec="bwt", block_size=BIG_BLOCK)
    need(launches, {"mtf_encode": 1, "mtf_decode": 1, "ari_encode": 1,
                    "ari_decode": 1}, "bwt_big")
    if not blob[5] & 8:
        raise AssertionError("a 100 MB bwt block did not take flag 8")
    nseg, seg = struct.unpack_from("<HI", blob, 26 + 4 + 4)
    rows = {tuple(c[0][0].shape) for c in calls["mtf"]}
    if (nseg, seg) != (128, 781312) or rows != {(128, 781312)}:
        raise AssertionError(f"segments {nseg} x {seg}, MTF rows {rows}")
    mtf = mtf_against_plain(calls["mtf"],
                            mtf_cut(MTF_PLAIN_COLS["bwt_big"]))
    ari = ari_prefix_against_plain(calls, ARI_PLAIN_COLS)
    calls.clear()
    emit("bwt_big", corpus_bytes=len(data), block_size=BIG_BLOCK,
         segments=nseg, segment_bytes=seg, container_bytes=len(blob),
         ratio=len(blob) / len(data), launches=launches,
         encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec,
         peak_device_bytes={"encode": peak_enc, "decode": peak_dec},
         mtf=mtf, ari=ari, card=smi)
    return launches, {**mtf, **ari}


def dc_bound(vals) -> dict:
    """bound() of one DC walk: vals, first and lengths read, the three
    (B, T) outputs and err written."""
    b, t = vals.shape
    return bound(16 * b * t + 4 * 256 * b + 8 * b)


def dc_against_plain(calls, steps: int) -> dict:
    """The path's one DC-walk launch: the kernel and the plain version both
    run on its inputs cut to the first `steps` steps, all four outputs
    exact (the err of a walk the cut leaves unfinished included), and the
    path launch's own first `steps` triples equal theirs (the walk is
    causal).  Times of the kernel at the path's shape and at the cut, of
    the plain version at the cut."""
    if len(calls) != 1:
        raise AssertionError(f"dc_decode: {len(calls)} launches on the "
                             "path, expected 1")
    (args, kw, out), = calls
    vals, first, length = args
    cut = vals[:, :steps].contiguous()
    ref, plain_ms = timed(
        lambda: dc_scan.dc_decode_lanes_plain(cut, first, length))
    got = dc_scan.dc_decode_lanes(cut, first, length)
    err = max(max(max_err(x, y) for x, y in zip(got, ref)),
              max(max_err(x[:, :steps], y) for x, y in zip(out[:3], ref)))
    if err:
        raise AssertionError("dc_decode disagrees with its plain version on "
                             f"the path's inputs: max_abs_err {err}")
    return {"inputs": list(vals.shape), "plain_inputs": list(cut.shape),
            "max_abs_err": err, "unfinished_at_cut": int(ref[3].sum()),
            "ms": cuda_ms(lambda: dc_scan.dc_decode_lanes(*args), 3),
            "ms_at_plain_inputs": cuda_ms(
                lambda: dc_scan.dc_decode_lanes(cut, first, length), 3),
            "plain_ms": plain_ms, **dc_bound(vals)}


def phase_bwtdc(smi: str):
    data = text_corpus(CORPUS_BYTES, SEED)
    tpuzip_torch.decompress(tpuzip_torch.compress(
        data[: 2 * BWT_BLOCK], codec="bwtdc", block_size=BWT_BLOCK))
    blob, calls, launches, t_enc, t_dec, peak_enc, peak_dec = round_trip(
        data, codec="bwtdc", block_size=BWT_BLOCK)
    need(launches, {"dc_decode": 1, "ari_encode": 1, "ari_decode": 1},
         "bwtdc")
    if blob[5] & 8 or struct.unpack_from("<I", blob, 6)[0] != BWT_BLOCK:
        raise AssertionError("bwtdc did not take 1 MiB blocks, flag 2")
    trace = trace_in_child("bwtdc")
    # the DC streams (the ari encoder's input rows) against the oracle's DC
    # of the oracle's BWT
    blocks_np, lens_np = blk.chunk(data, BWT_BLOCK)
    (args, _, _), = calls["ari_encode"]
    syms, dlens = args[:2]
    nb = blocks_np.shape[0]
    checked = sorted({0, 1, nb // 2, nb - 1})
    for i in checked:
        L, _ = obwt.encode_block(blocks_np[i, : lens_np[i]].tobytes())
        got = syms[i, : int(dlens[i])].cpu().numpy().tobytes()
        if got != odc.encode(L):
            raise AssertionError(f"bwtdc block {i}: DC stream differs from "
                                 "the oracle")
    kernels = {"dc_decode": dc_against_plain(calls["dc_decode"],
                                             DC_PLAIN_STEPS),
               **ari_prefix_against_plain(calls, ARI_PLAIN_COLS)}
    calls.clear()
    emit("bwtdc", corpus_bytes=len(data), block_size=BWT_BLOCK, blocks=nb,
         container_bytes=len(blob), ratio=len(blob) / len(data),
         launches=launches, oracle_blocks=checked,
         dc_stream_bytes=int(dlens.sum()),
         encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec,
         peak_device_bytes={"encode": peak_enc, "decode": peak_dec},
         kernels=kernels, trace=trace, card=smi)
    return launches, kernels, peak_enc


def bin_bound(kind: str, args, out) -> dict:
    """bound() of one bin launch at its own inputs: the valid bytes and the
    stream bytes written (encode) or the stream bytes consumed and the
    bytes written (decode), with the lengths and the chunk index."""
    if kind == "bin_encode":
        blocks, lens = args[:2]
        streams, slens, deltas = out
        nbytes = (int(lens.sum()) + 4 * lens.numel() + int(slens.sum())
                  + 4 * slens.numel() + 4 * deltas.numel())
    else:
        streams, deltas, nbits = args[:3]
        nbytes = (int(deltas.sum()) + 4 * deltas.shape[0]
                  + 4 * deltas.numel() + 4 * nbits.numel() + out.numel())
    return bound(nbytes)


def bin_against_plain(runs, cut: int) -> dict:
    """Each path's one launch of each bin kernel (runs: {codec: calls})
    held against the plain version on the path's own tensors cut to the
    first `cut` bytes of every block.  Kernel and plain run on the same
    cut, exact; the path launch's own outputs agree on that prefix (the
    coder is causal and carryless: its chunk index and its stream up to the
    cut's finish bytes, whole on the rows the cut leaves whole; decode:
    the first `cut` bytes).  One plain run of each direction holds both
    codecs, a knob setting a row."""
    enc, dec = [], []
    for codec, calls in runs.items():
        for name in ("bin_encode", "bin_decode"):
            if len(calls[name]) != 1:
                raise AssertionError(f"{codec} {name}: {len(calls[name])} "
                                     "launches on the path, expected 1")
        enc.append(calls["bin_encode"][0])
        dec.append(calls["bin_decode"][0])
    pairs = [tuple(a[2:]) for a, _, _ in enc]
    b = enc[0][0][0].shape[0]
    knobs = knob_rows(pairs, b)
    cuts = [(a[0][:, :cut].contiguous(), a[1].clamp(max=cut))
            for a, _, _ in enc]
    ref, enc_plain_ms = timed(lambda: bin_coder.bin_encode_indexed_plain(
        torch.cat([c[0] for c in cuts]), torch.cat([c[1] for c in cuts]),
        **knobs))
    nc = cut * 8 // bin_coder.CHUNK
    errs = []
    for j, ((args, _, out), (blocks, lens)) in enumerate(zip(enc, cuts)):
        mine = [r[j * b : (j + 1) * b] for r in ref]
        got = bin_coder.bin_encode_indexed(blocks, lens, *args[2:])
        streams, slens, deltas = out
        whole = args[1] <= cut
        agree = mine[1].to(torch.int64) - 4 * (~whole)
        w = mine[0].shape[1]
        keep = torch.arange(w, device="cuda")[None, :] < agree[:, None]
        errs.append(max(
            max(max_err(x, y) for x, y in zip(got, mine)),
            max_err(deltas[:, :nc], mine[2]),
            max_err(torch.where(keep, streams[:, :w], 0),
                    torch.where(keep, mine[0], 0)),
            max_err(torch.where(whole, slens, 0),
                    torch.where(whole, mine[1], 0))))
    dec_cuts = [(args[0], args[1][:, :nc].contiguous(),
                 args[2].clamp(max=8 * cut)) for args, _, _ in dec]
    width = max(c[0].shape[1] for c in dec_cuts)
    dref, dec_plain_ms = timed(lambda: bin_coder.bin_decode_indexed_plain(
        torch.cat([torch.nn.functional.pad(c[0], (0, width - c[0].shape[1]))
                   for c in dec_cuts]),
        torch.cat([c[1] for c in dec_cuts]),
        torch.cat([c[2] for c in dec_cuts]), **knobs))
    for j, ((args, _, out), c) in enumerate(zip(dec, dec_cuts)):
        mine = dref[j * b : (j + 1) * b]
        got = bin_coder.bin_decode_indexed(*c, *args[3:])
        errs.append(max(max_err(got, mine), max_err(out[:, :cut], mine)))
    err = max(errs)
    if err:
        raise AssertionError("a bin kernel disagrees with its plain version "
                             f"on the path's inputs: max_abs_err {err}")
    res = {}
    for name, launches, plain_ms, pshape in (
            ("bin_encode", enc, enc_plain_ms, list(ref[0].shape)),
            ("bin_decode", dec, dec_plain_ms, list(dref.shape))):
        (args, kw, out), = [c for c in launches if c[0][-1]]      # apm
        (bargs, bkw, bout), = [c for c in launches if not c[0][-1]]
        kernel = getattr(bin_coder, f"{name}_indexed")
        res[name] = {
            "inputs": [list(a.shape) for a in args[:2]],
            "plain_inputs": pshape, "max_abs_err": err,
            "ms": cuda_ms(lambda: kernel(*args, **kw), 3),
            "ms_bin": cuda_ms(lambda: kernel(*bargs, **bkw), 3),
            "plain_ms": plain_ms, **bin_bound(name, args, out),
            "bound_ms_bin": bin_bound(name, bargs, bout)["bound_ms"]}
    return res


def oracle_bits(block: bytes, apm: bool) -> bytes:
    """The oracle chain of tests/test_jax_bin_apm.py: the block's bits
    MSB-first through BinaryModel, or ApmGate over it, and the range
    coder."""
    model, gate, enc = oari.BinaryModel(), oari.ApmGate(), oari.RangeEncoder()
    one = 1 << oari.ApmBit.BITS
    for bit in np.unpackbits(np.frombuffer(block, np.uint8)).tolist():
        if apm:
            p0 = gate.pass_through(model.p0)
            enc.encode(*((0, p0) if bit == 0 else (p0, one)), one)
            gate.update(bit, 5)
        else:
            enc.encode(*model.get_range(bit), model.get_denominator())
        model.update(bit)
    return enc.finish()


def phase_bin(smi: str):
    data = text_corpus(CORPUS_BYTES, SEED)
    blocks_np, lens_np = blk.chunk(data, BLOCK)
    runs, launches, out, blobs = {}, {}, {}, {}
    for codec in ("bin", "apm"):
        tpuzip_torch.decompress(tpuzip_torch.compress(
            data[: 4 * BLOCK], codec=codec, block_size=BLOCK))
        blob, calls, counts, t_enc, t_dec, peak_enc, peak_dec = round_trip(
            data, codec=codec, block_size=BLOCK)
        need(counts, {"bin_encode": 1, "bin_decode": 1}, codec)
        if blob[5] != 2 or struct.unpack_from("<I", blob, 6)[0] != BLOCK:
            raise AssertionError(f"{codec} did not take 64 KiB blocks, flag 2")
        parts = payloads(blob, 0)
        checked = [0, len(parts) // 2]
        for i in checked:
            exp = oracle_bits(blocks_np[i, : lens_np[i]].tobytes(),
                              codec == "apm")
            if parts[i][2] != exp:
                raise AssertionError(f"{codec} block {i} stream differs from "
                                     "the oracle")
        out[codec] = {
            "container_bytes": len(blob), "ratio": len(blob) / len(data),
            "launches": counts, "oracle_blocks": checked,
            "encode_mb_s": len(data) / 1e6 / t_enc,
            "decode_mb_s": len(data) / 1e6 / t_dec,
            "peak_device_bytes": {"encode": peak_enc, "decode": peak_dec}}
        if codec == "apm":
            out[codec]["trace"] = trace_in_child("apm")
        runs[codec], launches[codec], blobs[codec] = calls, counts, blob
    kernels = bin_against_plain(runs, BIN_PLAIN_BYTES)
    runs.clear()
    emit("bin", corpus_bytes=len(data), block_size=BLOCK,
         blocks=int(blocks_np.shape[0]), codecs=out, kernels=kernels,
         card=smi)
    return launches, kernels, blobs["apm"]


def unindexed_against_plain(name: str, calls, cols: int, blob: bytes
                            ) -> dict:
    """A legacy path's one launch of a decoder without the chunk index
    held against the plain version on the same CUDA rows with the lengths
    and the output cut to the first `cols` symbols (bytes for the bit
    coder; the coders are causal): kernel and plain on the cut, exact, and
    the path launch's own first cols outputs equal to theirs.  Times of
    the kernel at the path's shape and at the cut, of the plain version at
    the cut; the bound at the path's shape: the payload bytes of the
    container, the lengths and the bytes written."""
    if len(calls) != 1:
        raise AssertionError(f"{name}: {len(calls)} launches on the legacy "
                             "path, expected 1")
    (args, kw, out), = calls
    comp, lens, out_n = args[:3]
    knobs = args[3:]
    cut_lens = lens.clamp(max=cols)
    if name == "ari_decode":
        wrapper = range_decoder.decode_batch
        plain = lambda: range_decoder.decode_batch_plain(  # noqa: E731
            comp, cut_lens, cols, *knobs)
    else:
        wrapper = bin_apm.decode_batch
        nc = -(-8 * cols // bin_coder.CHUNK)
        plain = lambda: bin_coder.bin_decode_indexed_plain(  # noqa: E731
            comp, None, (8 * cut_lens).to(torch.int32), *knobs,
            nc=nc)[:, :cols]
    ref, plain_ms = timed(plain)
    got = wrapper(comp, cut_lens, cols, *knobs)
    err = max(max_err(got, ref), max_err(out[:, :cols], ref))
    if err:
        raise AssertionError(f"{name} without the index disagrees with its "
                             f"plain version: max_abs_err {err}")
    nb = struct.unpack_from("<I", blob, 10)[0]
    payload = int(np.frombuffer(blob, "<u4", nb, 26).astype(np.int64).sum())
    return {"inputs": [list(comp.shape), list(lens.shape)],
            "plain_inputs": list(ref.shape), "max_abs_err": err,
            "ms": cuda_ms(lambda: wrapper(*args, **kw), 3),
            "ms_at_plain_inputs": cuda_ms(
                lambda: wrapper(comp, cut_lens, cols, *knobs), 3),
            "plain_ms": plain_ms,
            **bound(payload + 4 * lens.numel() + out.numel())}


def phase_legacy(smi: str, blobs: dict):
    """The ari and apm paths' own containers with their chunk index
    stripped (flag 2 clear, as tpuzip's run_job writes them), decoded on
    cuda through the no-index modes of ari_decode.cu and bin_decode.cu:
    the bytes, the launch counts and a prefix against the plain
    versions."""
    data = text_corpus(CORPUS_BYTES, SEED)
    res, kernels, launches = {}, {}, {}
    for codec, kernel, cols in (("ari", "ari_decode", ARI_PLAIN_COLS),
                                ("apm", "bin_decode", BIN_PLAIN_BYTES)):
        legacy = strip_index(blobs[codec])
        with counted_run() as (calls, counts):
            t0 = time.perf_counter()
            back = tpuzip_torch.decompress(legacy, device="cuda")
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
        if back != data:
            raise AssertionError(f"legacy {codec} container did not decode")
        need(counts, {f"{kernel}_unindexed": 1}, f"legacy {codec}")
        if counts[kernel]:
            raise AssertionError(f"legacy {codec}: the indexed {kernel} ran")
        kernels[kernel] = unindexed_against_plain(
            kernel, calls[f"{kernel}_unindexed"], cols, legacy)
        calls.clear()
        res[codec] = {"container_bytes": len(legacy), "flags": legacy[5],
                      "launches": counts,
                      "decode_mb_s": len(data) / 1e6 / t_dec,
                      "kernel": kernels[kernel]}
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    emit("legacy", corpus_bytes=len(data), block_size=BLOCK, codecs=res,
         card=smi)
    return launches, kernels


LZ = {"lz4": (lz4_coder, 1, olz4.compress_block),   # (coder, id, oracle)
      "rle": (rle_coder, 2, orle.encode)}


def lz_streams(blob: bytes) -> list:
    """Every block's stream of a container with one plain stream a block
    (lz4, rle), parsed here so the check does not lean on the code under
    test."""
    flags = blob[5]
    nb = struct.unpack_from("<I", blob, 10)[0]
    clens = np.frombuffer(blob, "<u4", nb, 26)
    off = 26 + 4 * nb + (4 * nb if flags & 1 else 0) + (6 if flags & 4 else 0)
    out = []
    for n in clens:
        out.append(blob[off : off + int(n)])
        off += int(n)
    return out


def lz_bound(kind: str, args, out) -> dict:
    """bound() of one lz4 or rle launch at its own inputs: encode reads the
    valid bytes and the lengths and writes the streams and their lengths;
    decode reads the streams and their lengths and writes every byte of
    its rows and the statuses."""
    rows, lens = args[:2]
    if kind == "encode":
        nbytes = (int(lens.sum()) + 4 * lens.numel() + int(out[1].sum())
                  + 4 * out[1].numel())
    else:
        nbytes = (int(lens.clamp(max=rows.shape[1]).sum()) + 4 * lens.numel()
                  + out[0].numel() + 8 * out[1].numel())
    return bound(nbytes)


def lz_against_plain(codec: str, calls, rows: list) -> dict:
    """The path's one launch of each of the codec's kernels held, exact,
    against its plain version on `rows` whole blocks of the launch's own
    tensors (an LZ4 stream is not causal near a block's end, so no prefix
    will do): the kernel on those rows and the launch's own rows both equal
    the plain version's.  Times of each kernel at the path's shape and on
    the rows, of the plain version on the rows; the bound at the path's
    shape."""
    coder = LZ[codec][0]
    pick = torch.tensor(rows, device="cuda")
    res = {}
    for kind in ("encode", "decode"):
        name = f"{codec}_{kind}"
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} launches on "
                                 "the path, expected 1")
        (args, kw, out), = calls[name]
        cut = (args[0][pick].contiguous(), args[1][pick].contiguous(),
               *args[2:])
        wrapper = getattr(coder, f"{name}_batch")
        ref, plain_ms = timed(
            lambda: getattr(coder, f"{name}_batch_plain")(*cut, **kw))
        got = wrapper(*cut, **kw)
        err = max(max(max_err(a, c) for a, c in zip(got, ref)),
                  max(max_err(a[pick], c) for a, c in zip(out, ref)))
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the path's inputs: max_abs_err {err}")
        res[name] = {
            "inputs": [list(a.shape) for a in args[:2]],
            "plain_inputs": list(cut[0].shape), "plain_rows": rows,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: wrapper(*args, **kw), 3),
            "ms_at_plain_inputs": cuda_ms(lambda: wrapper(*cut, **kw), 3),
            "plain_ms": plain_ms, **lz_bound(kind, args, out)}
    return res


def phase_lz(smi: str, codec: str):
    """The lz4 path (tpuzip_torch.compress with no codec argument: the
    default) or the rle path on the 64 MiB corpus at 64 KiB blocks."""
    data = text_corpus(CORPUS_BYTES, SEED)
    kw = {} if codec == "lz4" else {"codec": codec}
    tpuzip_torch.decompress(tpuzip_torch.compress(data[: 4 * BLOCK], **kw))
    blob, calls, counts, t_enc, t_dec, peak_enc, peak_dec = round_trip(
        data, **kw)
    need(counts, {f"{codec}_encode": 1, f"{codec}_decode": 1}, codec)
    coder, cid, oracle = LZ[codec]
    if blob[4:6] != bytes([cid, 0]) or \
            struct.unpack_from("<I", blob, 6)[0] != BLOCK:
        raise AssertionError(f"{codec}: codec id {blob[4]}, flags {blob[5]}, "
                             "expected 64 KiB blocks and flags 0")
    blocks_np, lens_np = blk.chunk(data, BLOCK)
    streams = lz_streams(blob)
    nb = len(streams)
    rows = sorted({0, 1, 2, nb // 3, nb // 2, 2 * nb // 3, nb - 2, nb - 1})
    for i in rows:
        if streams[i] != oracle(blocks_np[i, : lens_np[i]].tobytes()):
            raise AssertionError(f"{codec} block {i} stream differs from the "
                                 "oracle")
    kernels = lz_against_plain(codec, calls, rows)
    calls.clear()
    compress = lambda: tpuzip_torch.compress(data, **kw)       # noqa: E731
    decompress = lambda: tpuzip_torch.decompress(blob)          # noqa: E731
    emit(codec, corpus_bytes=len(data), block_size=BLOCK, blocks=nb,
         container_bytes=len(blob), ratio=len(blob) / len(data),
         launches=counts, oracle_blocks=rows,
         encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec,
         encode_kernel_mb_s=len(data) / 1e3
         / kernels[f"{codec}_encode"]["ms"],
         decode_kernel_mb_s=len(data) / 1e3
         / kernels[f"{codec}_decode"]["ms"],
         peak_device_bytes={"encode": peak_enc, "decode": peak_dec},
         kernels=kernels, trace=trace_in_child(codec),
         host_profile={"encode": host_profile(compress),
                       "decode": host_profile(decompress)}, card=smi)
    return counts, kernels, sum(map(len, streams))


# the kernels the serving path launches and does not, by codec
SERVE_NEEDS = {
    "lz4": ({"lz4_dense_words": 1, "lz4_dense_words_parse": 1,
             "lz4_decode": 1},
            ("lz4_encode", "lz4_links_tiled", "lz4_links_sorted",
             "lz4_dense_words_links")),
    "rle": ({"rle_encode_seg": 1, "rle_decode": 1}, ("rle_encode",)),
    "ari": ({"ari_encode": 1, "ari_decode": 1}, ()),
    "bwt": ({"ari_encode": 1, "ari_decode": 1, "mtf": 2}, ()),
    "bwtdc": ({"ari_encode": 1, "ari_decode": 1, "dc_decode": 1}, ()),
    "bin": ({"bin_encode": 1, "bin_decode_unindexed": 1}, ("bin_decode",)),
    "apm": ({"bin_encode": 1, "bin_decode_unindexed": 1}, ("bin_decode",)),
    # tpuzip's device deflate rule: the greedy parse and the tuple tables,
    # never the C++ rule's lazy parse and std::sort tables
    "deflate": ({"deflate_links_shared": 1, "deflate_parse_greedy": 1,
                 "deflate_emit_tuple": 1, "inflate": 1},
                ("deflate_links", "deflate_parse", "deflate_emit"))}
# the serving path's new launches, each held against its plain version:
# (wrapper module, wrapper, plain version)
SERVE_KERNELS = {
    "lz4_links_sorted": (lz4_links, "lz4_links_sorted", "lz4_links_plain"),
    "lz4_dense_words": (lz4_dense, "lz4_dense_words",
                        "lz4_dense_words_plain"),
    "lz4_dense_words_links": (lz4_dense, "lz4_dense_words_links",
                              "lz4_dense_words_links_plain"),
    "lz4_dense_words_parse": (lz4_dense, "lz4_dense_words_parse",
                              "lz4_dense_words_parse_plain"),
    "rle_encode_seg": (rle_coder, "rle_encode_segments_batch",
                       "rle_encode_segments_batch_plain"),
    # and the lz4p path's (phase 16), in compress and in serving
    "lz4p_pack": (lz4p_coder, "lz4p_pack", "lz4p_pack_plain"),
    "lz4p_decode": (lz4p_coder, "lz4p_decode_batch",
                    "lz4p_decode_batch_plain")}


def serving_tensor():
    """The 64 MiB corpus as a (1024, 65536) u8 CUDA tensor whose last row
    holds SERVE_TAIL bytes and random ones after them, its lengths, and
    the bytes it holds."""
    data = text_corpus(CORPUS_BYTES, SEED)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(
        -1, BLOCK).cuda()
    x[-1, SERVE_TAIL:] = torch.from_numpy(np.random.default_rng(
        SEED + 11).integers(0, 256, BLOCK - SERVE_TAIL, np.uint8)).cuda()
    lens = torch.full((x.shape[0],), BLOCK, dtype=torch.int32, device="cuda")
    lens[-1] = SERVE_TAIL
    return x, lens, data[: CORPUS_BYTES - BLOCK + SERVE_TAIL]


def serve_bound(name: str, args, out) -> dict:
    """bound() of one launch of a serving kernel at its own inputs: the
    valid bytes and the lengths read, the links written (and read by the
    words from them), the words written (and read by their parse), the
    streams and their lengths written; lz4p's
    pack reads LZ4 streams and writes lz4p rows, its decode reads those
    and writes every byte of its rows and the statuses."""
    rows, lens = args[:2]
    if name == "lz4p_decode":
        return lz_bound("decode", args, out)
    if name == "lz4p_pack":
        return bound(int(lens.sum()) + 4 * lens.numel()
                     + int(out[1].clamp(min=0).sum()) + 4 * out[1].numel())
    nbytes = int(lens.sum()) + 4 * lens.numel()
    if name in ("lz4_links_sorted", "lz4_dense_words"):
        return bound(nbytes + 4 * out.numel())
    if name == "lz4_dense_words_links":
        return bound(nbytes + 4 * args[2].numel() + 4 * out.numel())
    comp, clens = out
    nbytes += int(clens.sum()) + 4 * clens.numel()
    return bound(nbytes + (4 * args[2].numel() if len(args) > 2
                           and torch.is_tensor(args[2]) else 0))


def rows_against_plain(name: str, calls, rows: list) -> dict:
    """A path's one launch of a serving kernel held, exact, against its
    plain version on `rows` whole rows of the launch's own tensors: the
    kernel on those rows and the launch's own rows both equal the plain
    version's.  Times of the kernel at the path's shape and on the rows,
    of the plain version on the rows; the bound at the path's shape."""
    mod, wrapper, plain = SERVE_KERNELS[name]
    if len(calls[name]) != 1:
        raise AssertionError(f"{name}: {len(calls[name])} launches on the "
                             "path, expected 1")
    (args, kw, out), = calls[name]
    pick = torch.tensor(rows, device="cuda")
    cut = tuple(a[pick].contiguous() if torch.is_tensor(a) else a
                for a in args)
    ref, plain_ms = timed(lambda: getattr(mod, plain)(*cut, **kw))
    got = getattr(mod, wrapper)(*cut, **kw)
    tup = lambda v: v if isinstance(v, tuple) else (v,)   # noqa: E731
    err = max(max(max_err(a, c) for a, c in zip(tup(got), tup(ref))),
              max(max_err(a[pick], c) for a, c in zip(tup(out), tup(ref))))
    if err:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"the path's inputs: max_abs_err {err}")
    run = getattr(mod, wrapper)
    return {"inputs": [list(a.shape) for a in args if torch.is_tensor(a)],
            "plain_inputs": list(cut[0].shape), "plain_rows": rows,
            "max_abs_err": err, "ms": cuda_ms(lambda: run(*args, **kw), 3),
            "ms_at_plain_inputs": cuda_ms(lambda: run(*cut, **kw), 3),
            "plain_ms": plain_ms, **serve_bound(name, args, out)}


def deflate_serve_against_plain(calls) -> dict:
    """The serving deflate path's launches of tpuzip's device rule held,
    exact, against their plain versions: the greedy parse on the path's
    first 8 rows cut to DEFLATE_PLAIN_BYTES (on the plain links of the cut:
    the plain parse takes a Python step a token), the tuple tables with the
    emit on its first 8 whole rows of tokens, the path's own streams there
    too.  Times at the path's shape and on the cut, the plain version's on
    the cut; the bound at the path's shape."""
    dc = deflate_coder
    launch = {}
    for name in ("deflate_parse_greedy", "deflate_emit_tuple"):
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} launches on "
                                 "the serving path, expected 1")
        launch[name] = calls[name][0]
    (pargs, _, _) = launch["deflate_parse_greedy"]
    cut = pargs[0][:8, :DEFLATE_PLAIN_BYTES].contiguous()
    clen = pargs[1][:8].clamp(max=DEFLATE_PLAIN_BYTES).contiguous()
    pref = dc.deflate_links_plain(cut, clen)
    tref, parse_plain_ms = timed(
        lambda: dc.deflate_parse_plain(cut, clen, pref, 1, greedy=True))
    cut_args = {"deflate_parse_greedy": (cut, clen, pref)}
    (eargs, _, eout) = launch["deflate_emit_tuple"]
    cut_args["deflate_emit_tuple"] = tuple(a[:8].contiguous() for a in eargs)
    eref, emit_plain_ms = timed(lambda: dc.deflate_emit_plain(
        *cut_args["deflate_emit_tuple"], 0, "tuple"))
    errs = {"deflate_parse_greedy": max(max_err(a, c) for a, c in zip(
                dc.deflate_parse_greedy(*cut_args["deflate_parse_greedy"]),
                tref)),
            "deflate_emit_tuple": max(
                max(max_err(a, c) for a, c in zip(dc.deflate_emit_tuple(
                    *cut_args["deflate_emit_tuple"]), eref)),
                max(max_err(a[:8], c) for a, c in zip(eout, eref)))}
    if any(errs.values()):
        raise AssertionError("the device deflate rule's kernels disagree "
                             f"with their plain versions: {errs}")
    plain_ms = {"deflate_parse_greedy": parse_plain_ms,
                "deflate_emit_tuple": emit_plain_ms}
    res = {}
    for name, (args, kw, out) in launch.items():
        run = getattr(dc, name)
        res[name] = {
            "inputs": [list(a.shape) for a in args if torch.is_tensor(a)],
            "max_abs_err": errs[name],
            "plain_inputs": list(cut_args[name][0].shape),
            "plain_rows": list(range(8)),
            "ms": cuda_ms(lambda: run(*args, **kw), 3),
            "ms_at_plain_inputs": cuda_ms(lambda: run(*cut_args[name]), 3),
            "plain_ms": plain_ms[name], **deflate_bound(name, args, out)}
    return res


def phase_serving(smi: str):
    """Phase 13: device-resident serving.  The serving tensor through
    compress_from_device and decompress(to_device=True) for every codec:
    the tensor comes back up to the lengths, decompress gives the corpus
    bytes and the container's Adler-32 is zlib's; the kernels each codec
    needs launched (lz4: tpuzip's device encoder, csrc/lz4_dense.cu, and
    not lz4_encode.cu; rle: rle.cu's segment mode; deflate: its device
    rule, deflate_serve_against_plain), each new launch held
    against its plain version on 8 whole rows; then one
    compress(device_encode=True) at hash_log 16.  Wall MB/s (synchronised)
    and peak device memory of each direction, and device traces of the
    lz4, rle and deflate paths taken in a fresh process."""
    x, lens, data = serving_tensor()
    nb = x.shape[0]
    rows = sorted({0, 1, 2, nb // 3, nb // 2, 2 * nb // 3, nb - 2, nb - 1})
    keep = torch.arange(BLOCK, device="cuda")[None, :] < lens[:, None]
    want = torch.where(keep, x, 0)
    a32 = zlib.adler32(data)
    tpuzip_torch.decompress(tpuzip_torch.compress_from_device(
        x[:2].contiguous(), lens[:2], codec="lz4"), to_device=True)
    res, counts_all, kernels = {}, {}, {}
    for codec in CODECS:
        with counted_run() as (calls, counts):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            blob = tpuzip_torch.compress_from_device(x, lens, codec=codec)
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
            peak_enc = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, olens, orig = tpuzip_torch.decompress(blob, to_device=True)
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
            peak_dec = torch.cuda.max_memory_allocated()
        need_, never = SERVE_NEEDS[codec]
        need(counts, need_, f"serving {codec}")
        if any(counts[k] for k in never):
            raise AssertionError(f"serving {codec} launched {never}: "
                                 f"{counts}")
        back = (out.shape == x.shape and torch.equal(
            torch.where(keep, out, 0), want)
            and list(olens) == lens.tolist() and orig == len(data))
        host = tpuzip_torch.decompress(blob)
        if not back or host != data or \
                struct.unpack_from("<I", blob, 22)[0] != a32:
            raise AssertionError(f"serving {codec} did not round-trip")
        for name in SERVE_KERNELS:
            if counts[name]:
                kernels[name] = rows_against_plain(name, calls, rows)
        if codec == "deflate":
            kernels.update(deflate_serve_against_plain(calls))
        # one wrapper launches both MTF directions (as in round_trip)
        dec = sum(1 for _, kw_, _ in calls["mtf"] if kw_.get("decode"))
        counts.update(mtf_encode=counts["mtf"] - dec, mtf_decode=dec)
        calls.clear()
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
        res[codec] = {"container_bytes": len(blob), "flags": blob[5],
                      "ratio": len(blob) / len(data),
                      "encode_mb_s": len(data) / 1e6 / t_enc,
                      "decode_mb_s": len(data) / 1e6 / t_dec,
                      "peak_device_bytes": {"encode": peak_enc,
                                            "decode": peak_dec},
                      "launches": {k: v for k, v in counts.items() if v}}
        del out, blob
    # device_encode=True at 16 bits takes the shared route, at 20 the sorted
    # links, the words from them and their parse (lz4_dense.encode_route)
    enc_counts = {}
    for hl, needs in ((16, {"lz4_dense_words": 1,
                            "lz4_dense_words_parse": 1}),
                      (20, {"lz4_links_sorted": 1,
                            "lz4_dense_words_links": 1,
                            "lz4_dense_words_parse": 1})):
        cfg = Config()
        cfg.codec.lz4.device_encode, cfg.codec.lz4.hash_log = True, hl
        with counted_run() as (calls, enc_counts[hl]):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            blob = tpuzip_torch.compress(data, config=cfg)
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            back = tpuzip_torch.decompress(blob)
        need(enc_counts[hl], {**needs, "lz4_decode": 1},
             f"device_encode at hash_log {hl}")
        if back != data or enc_counts[hl]["lz4_encode"] or sum(
                enc_counts[hl][k] for k in (
                    "lz4_dense_words", "lz4_dense_words_links",
                    "lz4_links_tiled")) != 1:
            raise AssertionError("compress(device_encode=True) did not "
                                 "round-trip on its dense route: "
                                 f"{enc_counts[hl]}")
        if hl == 20:
            kernels["lz4_links_sorted"] = rows_against_plain(
                "lz4_links_sorted", calls, rows)
            kernels["lz4_dense_words_links"] = rows_against_plain(
                "lz4_dense_words_links", calls, rows)
            # the parse over these words: held too, its error folded into
            # the serving path's row
            err = rows_against_plain("lz4_dense_words_parse", calls,
                                     rows)["max_abs_err"]
            kernels["lz4_dense_words_parse"]["max_abs_err"] = max(
                kernels["lz4_dense_words_parse"]["max_abs_err"], err)
            # the sorted links' scratch at this shape, beside its output
            (largs, _, prev), = calls["lz4_links_sorted"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            lz4_links.lz4_links_sorted(*largs)
            torch.cuda.synchronize()
            kernels["lz4_links_sorted"]["scratch_peak_bytes"] = (
                torch.cuda.max_memory_allocated() - before
                - 4 * prev.numel())
            del largs, prev
        calls.clear()
        res[f"device_encode_hash_log_{hl}"] = {
            "container_bytes": len(blob), "ratio": len(blob) / len(data),
            "encode_mb_s": len(data) / 1e6 / t_enc,
            "peak_device_bytes": peak}
    trace = trace_in_child("serve")
    emit_traced("deflate_emit_tuple", trace["deflate"]["encode"], "row")
    emit("serving", corpus_bytes=len(data), rows=list(x.shape),
         last_length=SERVE_TAIL, codecs=res, kernels=kernels, trace=trace,
         card=smi)
    return counts_all, kernels, enc_counts


def corpus_peak(data: bytes, decode: bool = True, **kw):
    """compress_corpus of data on cuda, and decompress (TPZC) of its blob
    where `decode`: (blob, peak device bytes of the compress, seconds of
    each)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    blob = tpuzip_torch.compress_corpus(data, **kw)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not decode:
        return blob, peak, t_enc, None
    t0 = time.perf_counter()
    back = tpuzip_torch.decompress(blob)
    t_dec = time.perf_counter() - t0
    if back != data:
        raise AssertionError(f"compress_corpus {kw} did not round-trip")
    return blob, peak, t_enc, t_dec


def corpus_payload(blob: bytes) -> int:
    """The payload bytes of a TPZC blob of lz4 superbatches (the stream
    bytes of every block), parsed here."""
    (count,) = struct.unpack_from("<I", blob, 4)
    pos, total = 8, 0
    for _ in range(count):
        (ln,) = struct.unpack_from("<Q", blob, pos)
        total += sum(map(len, lz_streams(blob[pos + 8 : pos + 8 + ln])))
        pos += 8 + ln
    return total


def phase_corpus(smi: str, lz4_payload: int, dc_peak: int):
    """Phase 14: the corpus API.  A 256 MiB corpus (the 64 MiB one four
    times) through compress_corpus / decompress (TPZC) with the defaults
    (lz4, 64 KiB blocks, 8 MiB superbatches, 2 threads): its payload four
    times phase 11's; corpus_adler32 against zlib's; bwtdc at 1 MiB
    blocks through compress_corpus (fault 4: one compress call holds the
    whole corpus, phase 8's peak): on 64 and 256 MiB one superbatch at a
    time (pipeline=1), whose peak device memory may grow by less than 10%,
    and the 256 MiB round trip at the defaults (2 threads), whose peak
    may be at most two superbatches'.  With two threads the peak is the
    largest overlap of two superbatches' stages, which more superbatches
    sample more often: +5.6% and +12.2% from 64 to 256 MiB in two runs."""
    small = text_corpus(CORPUS_BYTES, SEED)
    data = small * 4
    t0 = time.perf_counter()
    a32 = runner.corpus_adler32(data)
    t_a32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = zlib.adler32(data)
    t_zlib = time.perf_counter() - t0
    if a32 != ref:
        raise AssertionError(f"corpus_adler32 {a32:#x} != zlib {ref:#x}")
    with counted_run() as (calls, counts):
        blob, peak, t_enc, t_dec = corpus_peak(data)
    calls.clear()
    # the wrappers' counts are not atomic, and two threads launch at once:
    # at least one launch of each
    need(counts, {"lz4_encode": 1, "lz4_decode": 1}, "corpus lz4")
    payload = corpus_payload(blob)
    if payload != 4 * lz4_payload:
        raise AssertionError(f"corpus lz4 payload {payload} != 4 x phase "
                             f"11's {lz4_payload}")
    res = {"lz4": {"container_bytes": len(blob),
                   "ratio": len(blob) / len(data),
                   "payload_bytes": payload,
                   "phase_11_ratio": lz4_payload / len(small),
                   "encode_mb_s": len(data) / 1e6 / t_enc,
                   "decode_mb_s": len(data) / 1e6 / t_dec,
                   "peak_device_bytes": peak}}
    peaks = {}
    for name, corpus, pipeline in (("64MiB_pipeline_1", small, 1),
                                   ("256MiB_pipeline_1", data, 1),
                                   ("256MiB", data, 2)):
        blob, peaks[name], t_enc, t_dec = corpus_peak(
            corpus, decode=pipeline == 2, codec="bwtdc",
            block_size=BWT_BLOCK, pipeline=pipeline)
        res[f"bwtdc_{name}"] = {
            "container_bytes": len(blob), "ratio": len(blob) / len(corpus),
            "encode_mb_s": len(corpus) / 1e6 / t_enc,
            "decode_mb_s": t_dec and len(corpus) / 1e6 / t_dec,
            "peak_device_bytes": peaks[name]}
    growth = peaks["256MiB_pipeline_1"] / peaks["64MiB_pipeline_1"] - 1
    emit("corpus", corpus_bytes=len(data), codecs=res,
         bwtdc_peak_growth=growth, bwtdc_phase_8_peak=dc_peak,
         corpus_adler32_s=t_a32, zlib_adler32_s=t_zlib, launches=counts,
         card=smi)
    if growth >= 0.10 or \
            peaks["256MiB"] > 2 * 1.02 * peaks["256MiB_pipeline_1"]:
        raise AssertionError(f"bwtdc's peak through compress_corpus grew "
                             f"with the corpus: {peaks}")
    return counts


def chain_against_plain(calls) -> dict:
    """The lz4_chain path's launches held, exact, against their plain
    versions on its first 8 rows cut to CHAIN_PLAIN_BYTES (the plain parse
    takes a Python step a sequence): each kernel on the cut equal to the
    plain version, and the path's own links on the cut's causal prefix
    (below length - 12 a link depends on no later byte) too.  Times of
    each kernel at the path's shape and on the cut, of the plain version
    on the cut; the bound at the path's shape."""
    for name in ("lz4_chain_links", "lz4_chain_best", "lz4_chain_parse"):
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} launches on "
                                 "the path, expected 1")
    (largs, lkw, prev), = calls["lz4_chain_links"]
    (bargs, bkw, words), = calls["lz4_chain_best"]
    (pargs, pkw, (comp, clens)), = calls["lz4_chain_parse"]
    blocks, lens, hash_log = largs[0], largs[1], largs[2]
    max_chain = pargs[3]
    cut = blocks[:8, :CHAIN_PLAIN_BYTES].contiguous()
    clen = lens[:8].clamp(max=CHAIN_PLAIN_BYTES).contiguous()
    pref, links_plain_ms = timed(
        lambda: lz4_chain.lz4_chain_links_plain(cut, clen, hash_log))
    got = lz4_chain.lz4_chain_links(cut, clen, hash_log)
    causal = CHAIN_PLAIN_BYTES - lz4_coder.MF_LIMIT
    links_err = max(max_err(got, pref),
                    max_err(prev[:8, :causal], pref[:, :causal]))
    wref, best_plain_ms = timed(lambda: lz4_chain.lz4_chain_best_plain(
        cut, clen, pref, max_chain))
    wcut = lz4_chain.lz4_chain_best(cut, clen, pref, max_chain)
    best_err = max_err(wcut, wref)
    ref, parse_plain_ms = timed(lambda: lz4_chain.lz4_chain_parse_plain(
        cut, clen, pref, max_chain, wref))
    parse_err = max(max_err(a, c) for a, c in zip(
        lz4_chain.lz4_chain_parse(cut, clen, pref, max_chain, wref), ref))
    if links_err or best_err or parse_err:
        raise AssertionError(f"lz4_chain disagrees with its plain version "
                             f"on the path's inputs: {links_err} {best_err} "
                             f"{parse_err}")
    valid = int(lens.sum()) + 4 * lens.numel()
    plain = {"plain_inputs": list(cut.shape), "plain_rows": list(range(8))}
    routes = lz4_chain.routes(hash_log, blocks.shape[1])
    return {
        "lz4_chain_links": {
            "inputs": [list(blocks.shape), list(lens.shape)],
            "max_abs_err": links_err, **plain, "hash_log": hash_log,
            "route": routes[0],
            "ms": cuda_ms(lambda: lz4_chain.lz4_chain_links(*largs, **lkw),
                          3),
            "ms_at_plain_inputs": cuda_ms(
                lambda: lz4_chain.lz4_chain_links(cut, clen, hash_log), 3),
            "plain_ms": links_plain_ms, **bound(valid + 4 * prev.numel())},
        "lz4_chain_best": {
            "inputs": [list(blocks.shape), list(lens.shape),
                       list(prev.shape)],
            "max_abs_err": best_err, **plain, "max_chain": max_chain,
            "cap": lz4_chain.BEST_CAP, "route": routes[1],
            "marked": int((words == lz4_chain.MARKED).sum()),
            "ms": cuda_ms(lambda: lz4_chain.lz4_chain_best(*bargs, **bkw),
                          3),
            "ms_at_plain_inputs": cuda_ms(
                lambda: lz4_chain.lz4_chain_best(cut, clen, pref,
                                                 max_chain), 3),
            "plain_ms": best_plain_ms,
            **bound(valid + 4 * prev.numel() + 4 * words.numel())},
        "lz4_chain_parse": {
            "inputs": [list(blocks.shape), list(lens.shape),
                       list(prev.shape), list(words.shape)],
            "max_abs_err": parse_err, **plain, "max_chain": max_chain,
            "ms": cuda_ms(lambda: lz4_chain.lz4_chain_parse(*pargs, **pkw),
                          3),
            "ms_at_plain_inputs": cuda_ms(
                lambda: lz4_chain.lz4_chain_parse(cut, clen, pref,
                                                  max_chain, wcut), 3),
            "plain_ms": parse_plain_ms,
            **bound(valid + 4 * words.numel() + int(clens.sum())
                    + 4 * clens.numel())}}


def lz4_wide(data: bytes):
    """The lz4 encoders at LZ4_WIDE_BLOCK blocks (tpuzip's block_size knob
    past 64 KiB, at hash_log 16): compress(device_encode=True) and compress
    at max_chain CHAIN_PATH_DEPTH of `data`, each decompressed back; both
    take csrc/lz4_links.cu's tiled links (the dense encoder then the words
    from them and their parse; the chained one best on device memory and
    its parse), never the shared kernels.  The links of each and the
    dense encoder's words held exact against their plain versions on the
    paths' first 8 whole rows (the kernels run there too) -> ({path:
    launch counts}, {path: the tiled links' row (times at the path's shape
    and on the 8 rows, the bound), each later launch's time, the ratio and
    the compress and decompress MB/s; the words' check})."""
    cut_rows = 8
    counts_by, res = {}, {}
    for path, knobs, needs, never in (
            ("lz4_wide_dense", {"device_encode": True, "hash_log": 16},
             {"lz4_links_tiled": 1, "lz4_dense_words_links": 1,
              "lz4_dense_words_parse": 1, "lz4_decode": 1},
             ("lz4_dense_words", "lz4_links_sorted", "lz4_encode")),
            ("lz4_wide_chain", {"max_chain": CHAIN_PATH_DEPTH,
                                "hash_log": 16},
             {"lz4_links_tiled": 1, "lz4_chain_best": 1,
              "lz4_chain_parse": 1, "lz4_decode": 1},
             ("lz4_chain_links", "lz4_links_sorted", "lz4_encode"))):
        cfg = Config()
        for k, v in knobs.items():
            setattr(cfg.codec.lz4, k, v)
        with counted_run() as (calls, counts):
            t0 = time.perf_counter()
            blob = tpuzip_torch.compress(data, block_size=LZ4_WIDE_BLOCK,
                                         config=cfg)
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = tpuzip_torch.decompress(blob)
            t_dec = time.perf_counter() - t0
        need(counts, needs, path)
        if back != data or any(counts[k] for k in never):
            raise AssertionError(f"{path}: round trip {back == data}, "
                                 f"launches {counts}")
        (args, kw, prev), = calls["lz4_links_tiled"]
        blocks, lens, bits = args
        cut = blocks[:cut_rows].contiguous()
        clen = lens[:cut_rows].contiguous()
        pref, plain_ms = timed(lambda: lz4_links.lz4_links_plain(cut, clen,
                                                                 bits))
        err = max(max_err(lz4_links.lz4_links_tiled(cut, clen, bits), pref),
                  max_err(prev[:cut_rows], pref))
        rec = {"inputs": [list(a.shape) for a in args if torch.is_tensor(a)],
               "bits": bits, "route": lz4_links.links_route(
                   bits, blocks.shape[1]), "max_abs_err": err,
               "plain_inputs": list(cut.shape),
               "plain_rows": list(range(cut_rows)), "plain_ms": plain_ms,
               "ms": cuda_ms(lambda: lz4_links.lz4_links_tiled(*args, **kw),
                             3),
               "ms_at_plain_inputs": cuda_ms(
                   lambda: lz4_links.lz4_links_tiled(cut, clen, bits), 3),
               **bound(int(lens.sum()) + 4 * lens.numel() + 4 * prev.numel())}
        if path == "lz4_wide_dense":
            (wargs, _, words), = calls["lz4_dense_words_links"]
            wref, wplain_ms = timed(
                lambda: lz4_dense.lz4_dense_words_links_plain(cut, clen,
                                                              pref))
            werr = max(max_err(lz4_dense.lz4_dense_words_links(cut, clen,
                                                               pref), wref),
                       max_err(words[:cut_rows], wref))
            res["lz4_dense_words_links"] = {
                "inputs": rec["inputs"] + [list(words.shape)],
                "max_abs_err": werr, "plain_ms": wplain_ms,
                "ms": cuda_ms(lambda: lz4_dense.lz4_dense_words_links(
                    *wargs), 3)}
            err = max(err, werr)
            del wargs, words
        if err:
            raise AssertionError(f"{path}: the tiled links or the words "
                                 f"disagree with their plain versions: "
                                 f"{rec}, {res}")
        rec.update(ratio=len(blob) / len(data),
                   encode_mb_s=len(data) / 1e6 / t_enc,
                   decode_mb_s=len(data) / 1e6 / t_dec)
        if path == "lz4_wide_dense":
            (pargs, _, _), = calls["lz4_dense_words_parse"]
            rec["words_parse_ms"] = cuda_ms(
                lambda: lz4_dense.lz4_dense_words_parse(*pargs), 3)
        else:
            (bargs, _, _), = calls["lz4_chain_best"]
            (pargs, _, _), = calls["lz4_chain_parse"]
            rec["best_ms"] = cuda_ms(lambda: lz4_chain.lz4_chain_best(*bargs),
                                     3)
            rec["parse_ms"] = cuda_ms(
                lambda: lz4_chain.lz4_chain_parse(*pargs), 3)
        calls.clear()
        res[path] = rec
        counts_by[path] = counts
    return counts_by, res


def phase_lz4_chain(smi: str, lz4_payload: int):
    """Phase 15: lz4 at max_chain CHAIN_PATH_DEPTH (tpuzip's chained
    encoder): compress of the 64 MiB corpus at 64 KiB blocks, then
    decompress (lz4_decode.cu reads any LZ4).  The bytes round-trip; both
    lz4_chain.cu launches and lz4_decode.cu run, lz4_encode.cu does not;
    the payload is smaller than phase 11's; each launch held against its
    plain version on the path's first rows cut to CHAIN_PLAIN_BYTES.  Then
    the wide lz4 paths (lz4_wide: 8 MiB at 128 KiB blocks, the tiled
    links)."""
    data = text_corpus(CORPUS_BYTES, SEED)
    cfg = Config()
    cfg.codec.lz4.max_chain = CHAIN_PATH_DEPTH
    tpuzip_torch.decompress(tpuzip_torch.compress(data[: 4 * BLOCK],
                                                  config=cfg))
    blob, calls, counts, t_enc, t_dec, peak_enc, peak_dec = round_trip(
        data, config=cfg)
    need(counts, {"lz4_chain_links": 1, "lz4_chain_best": 1,
                  "lz4_chain_parse": 1, "lz4_decode": 1}, "lz4_chain")
    if counts["lz4_encode"] or blob[4:6] != bytes([1, 0]):
        raise AssertionError(f"lz4_chain: codec id {blob[4]}, flags "
                             f"{blob[5]}, launches {counts}")
    payload = sum(map(len, lz_streams(blob)))
    if payload >= lz4_payload:
        raise AssertionError(f"max_chain {CHAIN_PATH_DEPTH} wrote {payload} "
                             f"bytes, the single probe {lz4_payload}")
    kernels = chain_against_plain(calls)
    calls.clear()
    wide_counts, wide = lz4_wide(data[:LZ4_WIDE_BYTES])
    # the tiled links' row: the dense wide path's launch; the chained one's
    # error beside it
    kernels["lz4_links_tiled"] = {**wide["lz4_wide_dense"], "max_abs_err": max(
        wide["lz4_wide_dense"]["max_abs_err"],
        wide["lz4_wide_chain"]["max_abs_err"])}
    kernels["lz4_dense_words_links_wide"] = wide["lz4_dense_words_links"]
    emit("lz4_chain", corpus_bytes=len(data), block_size=BLOCK,
         max_chain=CHAIN_PATH_DEPTH, container_bytes=len(blob),
         ratio=len(blob) / len(data), payload_bytes=payload,
         payload_over_lz4=payload / lz4_payload, launches=counts,
         encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec,
         encode_kernel_mb_s=len(data) / 1e3 / sum(
             kernels[k]["ms"] for k in ("lz4_chain_links", "lz4_chain_best",
                                        "lz4_chain_parse")),
         peak_device_bytes={"encode": peak_enc, "decode": peak_dec},
         wide={"bytes": LZ4_WIDE_BYTES, "block_size": LZ4_WIDE_BLOCK,
               "launches": wide_counts, **wide},
         kernels=kernels, trace=trace_in_child("lz4_chain"), card=smi)
    return counts, wide_counts, kernels


def phase_lz4p(smi: str):
    """Phase 16: the lz4p codec.  compress(codec="lz4p") and decompress of
    the 64 MiB corpus (tpuzip's C++ rule: lz4_encode.cu, then lz4p.cu's
    pack with runs split; lz4p.cu's decode), and compress_from_device and
    decompress(to_device=True) of the serving tensor (the XLA rule:
    lz4_dense.cu at hash_log 15, the pack unsplit).  The bytes round-trip
    both ways; each path's launches of lz4p.cu held against the plain
    versions on 8 whole rows of its own tensors; MB/s, ratio, peak memory
    and a device trace of each direction of both paths, taken in a fresh
    process."""
    data = text_corpus(CORPUS_BYTES, SEED)
    tpuzip_torch.decompress(tpuzip_torch.compress(data[: 4 * BLOCK],
                                                  codec="lz4p"))
    blob, calls, counts, t_enc, t_dec, peak_enc, peak_dec = round_trip(
        data, codec="lz4p")
    need(counts, {"lz4_encode": 1, "lz4p_pack": 1, "lz4p_decode": 1}, "lz4p")
    if blob[4:6] != bytes([7, 0]) or counts["lz4_decode"]:
        raise AssertionError(f"lz4p: codec id {blob[4]}, flags {blob[5]}, "
                             f"launches {counts}")
    nb = len(data) // BLOCK
    rows = sorted({0, 1, 2, nb // 3, nb // 2, 2 * nb // 3, nb - 2, nb - 1})
    kernels = {name: rows_against_plain(name, calls, rows)
               for name in ("lz4p_pack", "lz4p_decode")}
    calls.clear()
    x, lens, sdata = serving_tensor()
    keep = torch.arange(BLOCK, device="cuda")[None, :] < lens[:, None]
    tpuzip_torch.decompress(tpuzip_torch.compress_from_device(
        x[:2].contiguous(), lens[:2], codec="lz4p"), to_device=True)
    with counted_run() as (calls, serve_counts):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sblob = tpuzip_torch.compress_from_device(x, lens, codec="lz4p")
        torch.cuda.synchronize()
        s_enc = time.perf_counter() - t0
        speak_enc = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, olens, orig = tpuzip_torch.decompress(sblob, to_device=True)
        torch.cuda.synchronize()
        s_dec = time.perf_counter() - t0
        speak_dec = torch.cuda.max_memory_allocated()
    need(serve_counts, {"lz4_dense_words": 1, "lz4_dense_words_parse": 1,
                        "lz4p_pack": 1, "lz4p_decode": 1}, "lz4p serving")
    if not (torch.equal(torch.where(keep, out, 0), torch.where(keep, x, 0))
            and list(olens) == lens.tolist() and orig == len(sdata)
            and tpuzip_torch.decompress(sblob) == sdata):
        raise AssertionError("lz4p serving did not round-trip")
    serve_kernels = {name: rows_against_plain(name, calls, rows)
                     for name in ("lz4p_pack", "lz4p_decode")}
    calls.clear()
    emit("lz4p", corpus_bytes=len(data), block_size=BLOCK, blocks=nb,
         container_bytes=len(blob), ratio=len(blob) / len(data),
         launches=counts, encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec,
         peak_device_bytes={"encode": peak_enc, "decode": peak_dec},
         kernels=kernels, serving={
             "container_bytes": len(sblob), "ratio": len(sblob) / len(sdata),
             "launches": serve_counts,
             "encode_mb_s": len(sdata) / 1e6 / s_enc,
             "decode_mb_s": len(sdata) / 1e6 / s_dec,
             "peak_device_bytes": {"encode": speak_enc,
                                   "decode": speak_dec},
             "kernels": serve_kernels},
         trace={"compress": trace_in_child("lz4p"),
                "serving": trace_in_child("serve_lz4p")}, card=smi)
    return counts, serve_counts, kernels, serve_kernels


DEFLATE_CHAINS = (1, 8, 128)     # max_chain of deflate_encode.cu's checks
DEFLATE_PATH_CHAIN = 128         # the deflate path's: tpuzip's default
DEFLATE_PLAIN_BYTES = 4096       # bytes a row of that path's plain check
DEFLATE_GAPS = (32767, 32768, 32769)   # repeats at the window's edge
DEFLATE_FAR = 40 << 10           # bytes of the rows that hold them
# the deflate path's four launches (its 64 KiB rows take the shared links)
DEFLATE_NAMES = ("deflate_links_shared", "deflate_parse", "deflate_emit",
                 "inflate")
DEFLATE_WIDE_BLOCK = 1 << 17     # the wide path's blocks: the tiled links
DEFLATE_WIDE_BYTES = 8 << 20     # its corpus


def deflate_far_rows(seed: int):
    """(3, DEFLATE_FAR) u8 rows and lengths: random bytes whose 300 bytes
    at 33,000 repeat those DEFLATE_GAPS[r] back (taken up to 32,768, the
    window, and refused past it)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (len(DEFLATE_GAPS), DEFLATE_FAR), np.uint8)
    for r, gap in enumerate(DEFLATE_GAPS):
        rows[r, 33000:33300] = rows[r, 33000 - gap : 33300 - gap]
    return rows, np.full(len(rows), DEFLATE_FAR, np.int32)


def deflate_big_rows(seed: int):
    """(4, 128 KiB) u8 rows and lengths past the stored blocks' 65,535
    bytes: text, random bytes, and text cut to 65,535 and 65,536 bytes."""
    rng = np.random.default_rng(seed)
    n = 1 << 17
    text = np.frombuffer(text_corpus(n, seed), np.uint8)
    rows = np.stack([text, rng.integers(0, 256, n, np.uint8), text, text])
    lens = np.array([n, n, 65535, 65536], np.int32)
    rows[np.arange(n)[None, :] >= lens[:, None]] = 0
    return rows, lens


# the smoke's name of each route's links kernel
LINKS_ROUTE = {"shared": "deflate_links_shared", "tiled": "deflate_links"}


def deflate_check(x, xl, chains, modes=(0, 1)) -> dict:
    """deflate_encode.cu's launches on the rows against their plain
    versions, exact: the links, the parse at each max_chain of `chains`
    (on the plain links), the emit in each mode of `modes` on the plain
    tokens and stored (mode 2); and inflate.cu on every stream, each
    decoded back to its row."""
    dc = deflate_coder
    prev = dc.deflate_links(x, xl)
    pref, links_plain_ms = timed(lambda: dc.deflate_links_plain(x, xl))
    route = dc.links_route(x.shape[1])
    err = {LINKS_ROUTE[route]: max_err(prev, pref), "deflate_parse": 0,
           "deflate_emit": 0, "inflate": 0}
    rec = {"rows": list(x.shape), "links_route": route,
           "links_plain_ms": links_plain_ms}
    streams = {}
    for mc in chains:
        tok = dc.deflate_parse(x, xl, prev, mc)
        tref, plain_ms = timed(
            lambda: dc.deflate_parse_plain(x, xl, pref, mc))
        err["deflate_parse"] = max(err["deflate_parse"], *(
            max_err(a, c) for a, c in zip(tok, tref)))
        rec[f"parse_{mc}_plain_ms"] = plain_ms
        for mode in modes:
            got = dc.deflate_emit(x, xl, *tref, mode)
            ref = dc.deflate_emit_plain(x, xl, *tref, mode)
            err["deflate_emit"] = max(err["deflate_emit"], *(
                max_err(a, c) for a, c in zip(got, ref)))
            streams[f"mode_{mode}_chain_{mc}"] = got
    got = dc.deflate_emit(x, xl, None, None, 2)
    ref = dc.deflate_emit_plain(x, xl, None, None, 2)
    err["deflate_emit"] = max(err["deflate_emit"], *(
        max_err(a, c) for a, c in zip(got, ref)))
    streams["stored"] = got
    n = x.shape[1]
    keep = torch.arange(n, device="cuda")[None, :] < xl[:, None]
    want = torch.where(keep, x, 0)
    for name, (comp, clens) in streams.items():
        out, status = dc.inflate_batch(comp, clens, n)
        ref = dc.inflate_batch_plain(comp, clens, n)
        err["inflate"] = max(err["inflate"], max_err(out, ref[0]),
                             max_err(status, ref[1]))
        back = (torch.equal(status, xl.to(torch.int64))
                and torch.equal(out, want))
        rec[name] = {"stream_bytes": int(clens.sum()), "round_trip": back}
        if not back:
            raise AssertionError(f"deflate {name} streams did not decode "
                                 "back")
    rec["max_abs_err"] = err
    rec["streams"] = streams
    return rec


def deflate_link_rows(seed: int) -> dict:
    """{name: (rows, lengths, the links' route)} at the links' edges:
    65,536-byte rows (text, zeros after 16 random bytes, whose last slot
    takes p + 1 = 65,534, and run_rows()'s), a 65,537-byte row of text
    (the tiled route), zero rows, b"ab" rows (two hashes: six warps of the
    shared route's eight idle, no run) and rows of 0-3 bytes."""
    n = 1 << 16
    rng = np.random.default_rng(seed)
    edge = np.zeros((2, n), np.uint8)
    edge[0] = np.frombuffer(text_corpus(n, seed), np.uint8)
    edge[1, :16] = rng.integers(1, 256, 16)
    runs, _ = run_rows(n, seed + 1)
    wide = np.frombuffer(text_corpus(n + 1, seed + 2), np.uint8)[None]
    small = 4096
    rows = {"rows_65536": np.concatenate([edge, runs]),
            "row_65537": wide, "zero": np.zeros((4, small), np.uint8),
            "ab": np.tile(np.resize(np.array([97, 98], np.uint8), small),
                          (4, 1)),
            "bytes_0_to_3": np.tile(np.array([97, 98, 97, 99], np.uint8),
                                    (4, 1))}
    lens = {k: np.full(len(v), v.shape[1], np.int32)
            for k, v in rows.items()}
    lens["bytes_0_to_3"] = np.arange(4, dtype=np.int32)
    return {k: (rows[k], lens[k], deflate_coder.links_route(rows[k].shape[1]))
            for k in rows}


def links_edge_check(seed: int) -> dict:
    """deflate_encode.cu's links on deflate_link_rows(), each group on the
    route its shape gives (asserted by the route's launch count), exact
    against the plain links, then parsed at max_chain 8, emitted as
    dynamic blocks and inflated back to its rows by the kernels (zlib too
    on each group's first stream); an empty batch launches nothing."""
    dc = deflate_coder
    res, errs = {}, {}
    for name, (rows_np, lens_np, route) in deflate_link_rows(seed).items():
        x = torch.from_numpy(rows_np).cuda()
        xl = torch.from_numpy(lens_np).cuda()
        kernel = LINKS_ROUTE[route]
        wrapper = getattr(*WRAPPERS[kernel])
        before = wrapper.launches
        prev = dc.deflate_links(x, xl)
        if wrapper.launches != before + 1:
            raise AssertionError(f"links of {name}: not on the {route} "
                                 "route")
        e = max_err(prev, dc.deflate_links_plain(x, xl))
        errs[kernel] = max(errs.get(kernel, 0), e)
        tok, nt = dc.deflate_parse(x, xl, prev, 8)
        comp, clens = dc.deflate_emit(x, xl, tok, nt, 0)
        out, st = dc.inflate_batch(comp, clens, x.shape[1])
        keep = torch.arange(x.shape[1], device="cuda")[None, :] < xl[:, None]
        back = (torch.equal(st, xl.to(torch.int64))
                and torch.equal(out, torch.where(keep, x, 0))
                and zlib.decompress(comp[0, : clens[0]].cpu().numpy()
                                    .tobytes(), -15)
                == rows_np[0, : lens_np[0]].tobytes())
        res[name] = {"rows": list(x.shape), "route": route,
                     "max_abs_err": e, "round_trip": back,
                     "links_ms": cuda_ms(lambda: dc.deflate_links(x, xl), 3)}
        if not back:
            raise AssertionError(f"links edge rows {name} did not decode "
                                 "back")
    x = torch.zeros((0, 1 << 16), dtype=torch.uint8, device="cuda")
    before = dc.deflate_links_shared.launches
    if dc.deflate_links(x, torch.zeros(0, dtype=torch.int32, device="cuda")
                        ).shape != x.shape or \
            dc.deflate_links_shared.launches != before:
        raise AssertionError("links of an empty batch")
    res["max_abs_err"] = errs
    return res


def table_row(lits: dict, lcodes: dict, dcodes: dict, seed: int):
    """(tokens, raw bytes) of a valid token row whose literal bytes, length
    codes and distance codes come as often as the dicts say ({symbol:
    count}; the two match counts sum alike): the literals first, in an order
    mixed by the seed, then the matches by distance code, each at its
    codes' base length and base distance (asserted within the bytes before
    it), their length codes mixed by the seed."""
    dcf = deflate_coder
    rng = np.random.default_rng(seed)
    lit = rng.permutation(np.repeat(np.array(list(lits), np.int64),
                                    list(lits.values())))
    lcs = rng.permutation(np.repeat(np.array(list(lcodes), np.int64),
                                    list(lcodes.values())))
    dcs = np.repeat(sorted(dcodes), [dcodes[c] for c in sorted(dcodes)])
    if len(lcs) != len(dcs):
        raise AssertionError("a table row's length and distance counts "
                             "differ")
    raw = bytearray(lit.astype(np.uint8).tobytes())
    tokens = lit.tolist()
    for lc, code in zip(lcs.tolist(), dcs.tolist()):
        ln, d = dcf.LEN_BASE[lc], dcf.DIST_BASE[code]
        if d > len(raw):
            raise AssertionError("a table row's match reaches before it")
        for _ in range(ln):
            raw.append(raw[-d])
        tokens.append(ln << dcf.MATCH_SHIFT | d)
    return tokens, bytes(raw)


def table_specs() -> dict:
    """{row width: {name: table_row()'s three counts}} of the token rows
    built to stress deflate_encode.cu's tables: at 64 KiB every symbol of
    the three trees at one count, two counts only, counts in powers of
    two, Fibonacci counts (the literal/length tree past its 15-bit limit),
    a single literal, and literals with no match (one distance length); at
    the wide path's 128 KiB, Fibonacci and equal counts."""
    fib = [1, 1]
    while len(fib) < 24:
        fib.append(fib[-1] + fib[-2])
    return {
        65536: {
            "equal": ({s: 30 for s in range(256)},
                      dict.fromkeys(range(29), 30),
                      dict.fromkeys(range(30), 29)),
            "two_counts": ({s: 1 if s % 2 else 50 for s in range(256)},
                           {c: 15 if c < 14 else 30 for c in range(29)},
                           {c: 4 if c < 15 else 40 for c in range(30)}),
            "powers_of_two": ({s: 1 << s % 9 for s in range(256)},
                              {c: 1 << c % 8 for c in range(16)},
                              {c: 1 << c % 8 for c in range(16)}),
            "fibonacci": ({97 + k: fib[k] for k in range(22)},
                          {c: fib[c] for c in range(10)},
                          {c: fib[c] for c in range(10)}),
            "one_literal": ({120: 1}, {}, {}),
            "no_match": ({s: 1 + s % 37 for s in range(256)}, {}, {})},
        DEFLATE_WIDE_BLOCK: {
            "wide_fibonacci": ({k: fib[k] for k in range(22)},
                               {c: fib[c] for c in range(16)},
                               {c: fib[c] for c in range(16)}),
            "wide_equal": ({s: 60 for s in range(256)},
                           dict.fromkeys(range(29), 60),
                           dict.fromkeys(range(30), 58))}}


def table_rows(seed: int) -> dict:
    """{group: (tokens (B, n) i32, ntok (B,), raw rows (B, n) u8 zero past
    each row's bytes, their lengths (B,), the rows' names)} on the card:
    table_specs()'s rows by table_row(), and beside the 128 KiB ones 4 rows
    of the wide path's text through the links and the parse at max_chain
    128."""
    specs = table_specs()
    out = {}
    for n, rows in specs.items():
        built = [table_row(*spec, seed + k)
                 for k, spec in enumerate(rows.values())]
        names = list(rows)
        if n == DEFLATE_WIDE_BLOCK:
            text = np.frombuffer(text_corpus(4 * n, seed), np.uint8)
            x = torch.from_numpy(text.reshape(4, n).copy()).cuda()
            xl = torch.full((4,), n, dtype=torch.int32, device="cuda")
            tok, nt = deflate_coder.deflate_parse(
                x, xl, deflate_coder.deflate_links(x, xl), DEFLATE_PATH_CHAIN)
            built += [(tok[r, : int(nt[r])].tolist(), text[r * n:(r + 1) * n]
                       .tobytes()) for r in range(4)]
            names += [f"wide_text_{r}" for r in range(4)]
        tok = np.zeros((len(built), n), np.int32)
        for r, (t, raw) in enumerate(built):
            if len(raw) > n:
                raise AssertionError(f"table row {names[r]}: {len(raw)} "
                                     f"bytes past {n}")
            tok[r, : len(t)] = t
        raw, rl = padded([raw for _, raw in built], n)
        out[f"rows_{n}"] = (
            torch.from_numpy(tok).cuda(),
            torch.tensor([len(t) for t, _ in built], dtype=torch.int32,
                         device="cuda"), raw, rl, names)
    return out


def table_rows_check(seed: int) -> dict:
    """deflate_encode.cu's tables and emit (dynamic) on table_rows(),
    exact against deflate_emit_plain, each stream inflated back to its
    bytes by inflate.cu and by zlib."""
    dc = deflate_coder
    res, errs = {}, {"deflate_emit": 0, "inflate": 0}
    for group, (tok, nt, raw, rl, names) in table_rows(seed).items():
        got = dc.deflate_emit(raw, rl, tok, nt, 0)
        ref, plain_ms = timed(
            lambda: dc.deflate_emit_plain(raw, rl, tok, nt, 0))
        e = max(max_err(a, c) for a, c in zip(got, ref))
        errs["deflate_emit"] = max(errs["deflate_emit"], e)
        n = raw.shape[1]
        out, st = dc.inflate_batch(*got, n)
        iref = dc.inflate_batch_plain(*got, n)
        errs["inflate"] = max(errs["inflate"], max_err(out, iref[0]),
                              max_err(st, iref[1]))
        comp, clens = (a.cpu().numpy() for a in got)
        rows, lens = raw.cpu().numpy(), rl.tolist()
        back = (torch.equal(st, rl.to(torch.int64)) and torch.equal(out, raw)
                and all(zlib.decompress(comp[r, : clens[r]].tobytes(), -15)
                        == rows[r, : lens[r]].tobytes()
                        for r in range(len(names))))
        res[group] = {"rows": names, "bytes": lens,
                      "tokens": nt.tolist(), "stream_bytes": clens.tolist(),
                      "max_abs_err": e, "round_trip": back,
                      "emit_ms": cuda_ms(
                          lambda: dc.deflate_emit(raw, rl, tok, nt, 0), 3),
                      "plain_ms": plain_ms}
        if not back:
            raise AssertionError(f"table rows {group} did not decode back")
    res["max_abs_err"] = errs
    return res


def xla_rule_rows(seed: int) -> dict:
    """{group: (rows (B, n) u8 on the card, zero past each length,
    lengths)} for tpuzip's device deflate rule: 4 KiB rows of text, zeros,
    b"ab" and random bytes, and rows of 0 and 1 bytes; two 64 KiB rows of
    text and random bytes (the shared links) and two of 128 KiB (the tiled
    links)."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, k in ((4096, 0), (1 << 16, 1), (1 << 17, 2)):
        text = np.frombuffer(text_corpus(2 * n, seed + k), np.uint8)
        rows = [text[:n], rng.integers(0, 256, n, np.uint8)]
        lens = [n, n]
        if n == 4096:
            rows += [np.zeros(n, np.uint8),
                     np.resize(np.frombuffer(b"ab", np.uint8), n),
                     text[n:], text[n:]]
            lens += [n, n, 0, 1]
        x = np.stack(rows).copy()
        x[np.arange(n)[None, :] >= np.array(lens)[:, None]] = 0
        out[f"rows_{n}"] = (torch.from_numpy(x).cuda(),
                            torch.tensor(lens, dtype=torch.int32,
                                         device="cuda"))
    return out


def xla_rule_check(seed: int) -> dict:
    """tpuzip's device deflate rule on the card: deflate_encode.cu's greedy
    parse (the best kernel at max_chain 1, then the parse's greedy
    instance) and its tuple-order tables with the emit, exact against
    their plain versions, on xla_rule_rows() (the links on the route of
    each width, the parse on the plain links, the tables on the plain
    tokens) and, the tables alone, on table_rows(); every stream inflated
    back by inflate.cu and by zlib."""
    dc = deflate_coder
    res = {}
    errs = {"deflate_parse_greedy": 0, "deflate_emit_tuple": 0, "inflate": 0}
    groups = {}
    for name, (x, xl) in xla_rule_rows(seed).items():
        pref = dc.deflate_links_plain(x, xl)
        links = LINKS_ROUTE[dc.links_route(x.shape[1])]
        errs[links] = max(errs.get(links, 0),
                          max_err(dc.deflate_links(x, xl), pref))
        tok = dc.deflate_parse_greedy(x, xl, pref)
        tref, parse_plain_ms = timed(
            lambda: dc.deflate_parse_plain(x, xl, pref, 1, greedy=True))
        e = max(max_err(a, c) for a, c in zip(tok, tref))
        errs["deflate_parse_greedy"] = max(errs["deflate_parse_greedy"], e)
        res[name] = {"rows": list(x.shape), "lengths": xl.tolist(),
                     "parse_max_abs_err": e, "parse_plain_ms": parse_plain_ms,
                     "parse_ms": cuda_ms(
                         lambda: dc.deflate_parse_greedy(x, xl, pref), 3)}
        groups[name] = (tref[0], tref[1], x, xl)
    for group, (tok, nt, raw, rl, _) in table_rows(seed + 1).items():
        groups[f"table_{group}"] = (tok, nt, raw, rl)
    for name, (tok, nt, x, xl) in groups.items():
        got = dc.deflate_emit_tuple(x, xl, tok, nt)
        ref, plain_ms = timed(
            lambda: dc.deflate_emit_plain(x, xl, tok, nt, 0, "tuple"))
        e = max(max_err(a, c) for a, c in zip(got, ref))
        errs["deflate_emit_tuple"] = max(errs["deflate_emit_tuple"], e)
        n = x.shape[1]
        out, st = dc.inflate_batch(*got, n)
        iref = dc.inflate_batch_plain(*got, n)
        errs["inflate"] = max(errs["inflate"], max_err(out, iref[0]),
                              max_err(st, iref[1]))
        comp, clens = (a.cpu().numpy() for a in got)
        rows, lens = x.cpu().numpy(), xl.tolist()
        back = (torch.equal(st, xl.to(torch.int64)) and torch.equal(out, x)
                and all(zlib.decompress(comp[r, : clens[r]].tobytes(), -15)
                        == rows[r, : lens[r]].tobytes()
                        for r in range(len(lens))))
        res.setdefault(name, {}).update(
            emit_max_abs_err=e, stream_bytes=clens.tolist(), round_trip=back,
            emit_plain_ms=plain_ms, emit_ms=cuda_ms(
                lambda: dc.deflate_emit_tuple(x, xl, tok, nt), 3))
        if not back:
            raise AssertionError(f"device-rule streams of {name} did not "
                                 "decode back")
    res["max_abs_err"] = errs
    return res


def deflate_garbage(seed: int) -> list:
    """Streams no encoder of the port writes: 64 of random bytes under each
    block type, 64 of tpuzip-form streams with one bit flipped, and zlib's
    streams of several blocks (sync and full flushes, stored blocks between
    Huffman ones, levels 0, 1 and 9)."""
    rng = np.random.default_rng(seed)
    text = text_corpus(6000, seed)
    out = []
    for k in range(64):
        s = rng.integers(0, 256, int(rng.integers(1, 300)), np.uint8)
        s[0] = (int(s[0]) & 0xF9) | (2 * (k % 4))
        out.append(s.tobytes())
    good = zlib.compress(text[:3000], 9)[2:-4]
    for _ in range(64):
        s = bytearray(good)
        s[int(rng.integers(0, len(s)))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(s))
    for level in (0, 1, 6, 9):
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        s = b""
        for k in range(6):
            part = (text[k * 900 : (k + 1) * 900] if k % 2 else
                    rng.integers(0, 256, 500, np.uint8).tobytes())
            s += co.compress(part) + co.flush(
                (zlib.Z_SYNC_FLUSH, zlib.Z_FULL_FLUSH, zlib.Z_NO_FLUSH)[k % 3])
        out.append(s + co.flush())
    return out


def long_code_row(seed: int, n: int = 1 << 16):
    """(a row of at most n bytes, its deflate tokens) whose literal and
    distance codes reach past the inflate's root tables: after 300 random
    bytes and runs to 33,000 bytes, literals of 40 byte values and matches
    of 3-5 bytes whose distance codes fall with geometric frequencies (half
    as often each code), so the rare ones get codes of 12-15 bits."""
    rng = np.random.default_rng(seed)
    row = bytearray(rng.integers(0, 256, 300, np.uint8).tobytes())
    tokens = list(row)
    while len(row) < 33000:
        tokens.append(258 << deflate_coder.MATCH_SHIFT | 1)
        row += row[-1:] * 258
    while True:
        if rng.random() < 0.2:
            b = 97 + min(int(rng.geometric(0.5)) - 1, 39)
            if len(row) + 1 > n:
                return bytes(row), tokens
            tokens.append(b)
            row.append(b)
            continue
        k = min(int(rng.geometric(0.5)) - 1, 29)
        d = deflate_coder.DIST_BASE[k] + int(
            rng.integers(0, 1 << deflate_coder.DIST_EXTRA[k]))
        ln = int(rng.integers(3, 6))
        if len(row) + ln > n:
            return bytes(row), tokens
        tokens.append(ln << deflate_coder.MATCH_SHIFT | d)
        for _ in range(ln):
            row.append(row[-d])


def inflate_edge_streams(seed: int) -> list:
    """[(stream, raw bytes)] for the inflate's table and staging edges:
    two dynamic blocks (tpuzip's C++ form) whose literal codes reach 13-14
    bits and distance codes 12 (long_code_row; asserted), so they take the
    subtables, and the same tokens in a fixed block; zlib streams of text
    and random bytes in several blocks, whose random parts zlib stores
    right after Huffman blocks (fault 8's case, unaligned) in blocks that
    cross the stream's staged tiles, with and without flushes."""
    out = []
    for k in range(2):
        raw, tokens = long_code_row(seed + k)
        stream = deflate_coder._emit_row(raw, tokens, 0)
        rd = deflate_coder._Reader(stream)
        rd.bits(3)
        lit, dist = deflate_coder._dynamic_header(rd)
        if lit[1] < 12 or dist[1] < 12:
            raise AssertionError(f"long-code row {k}: its longest codes are "
                                 f"{lit[1]} and {dist[1]} bits")
        out.append((stream, raw))
        if k == 0:
            out.append((deflate_coder._emit_row(raw, tokens, 1), raw))
    rng = np.random.default_rng(seed)
    text = text_corpus(40000, seed)
    for k, flush in enumerate((zlib.Z_NO_FLUSH, zlib.Z_SYNC_FLUSH,
                               zlib.Z_FULL_FLUSH)):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        raw, stream = b"", b""
        for j in range(4):
            part = (text[j * 9000 : j * 9000 + 7000 + 1000 * k] if j % 2 == 0
                    else rng.integers(0, 256, 3000 + 700 * j,
                                      np.uint8).tobytes())
            raw += part
            stream += co.compress(part) + co.flush(flush)
        out.append((stream + co.flush(), raw))
    for stream, raw in out:
        if zlib.decompress(stream, -15) != raw:
            raise AssertionError("an inflate edge stream is not its bytes")
    return out


def inflate_symbols(stream: bytes) -> int:
    """The symbols (literals, matches and block ends) of a deflate stream,
    read with the plain decoder's parts; a fault ends the count."""
    dfc = deflate_coder
    rd = dfc._Reader(stream)
    count = 0
    try:
        while True:
            final, btype = rd.bits(1), rd.bits(2)
            if btype == 0:
                rd.pos = -(-rd.pos // 8) * 8
                at = rd.pos >> 3
                rd.pos = 8 * (at + 4 + (stream[at] | stream[at + 1] << 8))
            elif btype == 3:
                return count
            else:
                lit, dist = ((dfc._huffman(dfc.fixed_lit_lengths()),
                              dfc._huffman(dfc.fixed_dist_lengths()))
                             if btype == 1 else dfc._dynamic_header(rd))
                while True:
                    sym = dfc._decode(rd, lit)
                    count += 1
                    if sym == 256:
                        break
                    if sym > 256:
                        rd.bits(dfc.LEN_EXTRA[sym - 257])
                        rd.bits(dfc.DIST_EXTRA[dfc._decode(rd, dist)])
            if final:
                return count
    except (dfc._Fault, IndexError):
        return count


def segment_rows(seg: int, seed: int):
    """(rows (12, 4 seg) u8, zero past each length, lengths, {row: the
    match ends it must hold}) for the device rule's parse in segments of
    seg positions: zero rows and rows of period 258 over several
    segments, one of each cut inside its last segment (a walk from a
    segment's start never meets their true paths); random bytes whose
    copies end on the first segment's end and 257 past the second's;
    text over several segments cut inside the last, text of one segment
    and of exactly one, and rows of 1 and 0 bytes."""
    n = 4 * seg
    rng = np.random.default_rng(seed)
    text = np.frombuffer(text_corpus(n, seed), np.uint8)
    period = np.resize(rng.integers(0, 256, 258, np.uint8), n)
    edge = rng.integers(0, 256, n, np.uint8)
    for a, length, end in ((5, 100, seg), (110, 258, 2 * seg + 257)):
        edge[end - length : end] = edge[a : a + length]
        edge[end] = edge[a + length] ^ 0xFF   # the match stops there
    rows = [np.zeros(n, np.uint8), np.zeros(n, np.uint8), period, period,
            edge, text, text, text, text, text, text, text]
    lens = np.array([n, 3 * seg + 17, n, 2 * seg + 300, n, n, 3 * seg + 100,
                     3 * seg + 1, seg - 3, seg, 1, 0], np.int32)
    x = np.stack(rows)
    x[np.arange(n)[None, :] >= lens[:, None]] = 0
    return x, lens, {4: {seg, 2 * seg + 257}}


def tile_rows(tile: int, seed: int):
    """(rows (11, 3 tile) u8, zero past each length, lengths) for the
    links in tiles of tile positions: text (its words' hashes last seen
    one or two tiles back); random bytes whose second tile copies the
    first's and whose third copies the first's again (two tiles back); a
    random first and last tile around a zero tile (their hashes seen only
    there); zero and b"ab" rows; text cut so that its length ends in a
    tile's last two bytes, on a tile's end and just past it."""
    n = 3 * tile
    rng = np.random.default_rng(seed)
    text = np.frombuffer(text_corpus(n, seed + 1), np.uint8)
    back = rng.integers(0, 256, n, np.uint8)
    back[tile + 40 : tile + 140] = back[10:110]
    back[2 * tile + 7 : 2 * tile + 90] = back[120:203]
    ends = rng.integers(0, 256, n, np.uint8)
    ends[tile : 2 * tile] = 0
    ends[2 * tile + 50 : 2 * tile + 60] = ends[20:30]
    ab = np.resize(np.frombuffer(b"ab", np.uint8), n)
    rows = [text, back, ends, np.zeros(n, np.uint8), ab, text, text, text,
            text, text, text]
    lens = np.array([n, n, n, n, n - 1, 2 * tile - 1, 2 * tile, 2 * tile + 1,
                     2 * tile + 2, 2 * tile + 3, tile + 2], np.int32)
    x = np.stack(rows)
    x[np.arange(n)[None, :] >= lens[:, None]] = 0
    return x, lens


def match_ends(tok: list) -> set:
    """The positions where a row's match tokens end."""
    ends, p = set(), 0
    for t in tok:
        p += t >> 16 if t >= 1 << 16 else 1
        if t >= 1 << 16:
            ends.add(p)
    return ends


def segments_check(seed: int) -> dict:
    """The device rule's parse in segments and the tiled links at their
    edges: the greedy parse on segment_rows() at PARSE_SEG (the shared
    links) and the links on tile_rows() at LINK_TILE (the tiled route, its
    launch asserted), each exact against its plain version (the parse on
    the plain links), the edge row's matches ending on the segments'
    edges, the zero tile crossed by links; then the device rule's streams
    of both groups (the kernels' tokens, the tuple tables with the emit)
    inflated back by inflate.cu and zlib."""
    dc = deflate_coder
    res, errs = {}, {}
    sx, sl, ends = segment_rows(dc.PARSE_SEG, seed)
    tx, tl = tile_rows(dc.LINK_TILE, seed + 1)
    for name, (rows_np, lens_np) in (("segment_rows", (sx, sl)),
                                     ("tile_rows", (tx, tl))):
        x = torch.from_numpy(rows_np).cuda()
        xl = torch.from_numpy(lens_np).cuda()
        links = LINKS_ROUTE[dc.links_route(x.shape[1])]
        wrapper = getattr(*WRAPPERS[links])
        before = wrapper.launches
        prev = dc.deflate_links(x, xl)
        if wrapper.launches != before + 1:
            raise AssertionError(f"links of {name}: not on {links}")
        pref = dc.deflate_links_plain(x, xl)
        errs[links] = max(errs.get(links, 0), max_err(prev, pref))
        tok, nt = dc.deflate_parse_greedy(x, xl, pref)
        tref, plain_ms = timed(
            lambda: dc.deflate_parse_plain(x, xl, pref, 1, greedy=True))
        e = max(max_err(tok, tref[0]), max_err(nt, tref[1]))
        errs["deflate_parse_greedy"] = max(
            errs.get("deflate_parse_greedy", 0), e)
        comp, clens = dc.deflate_emit_tuple(x, xl, tok, nt)
        out, st = dc.inflate_batch(comp, clens, x.shape[1])
        cb, cl = comp.cpu().numpy(), clens.tolist()
        back = (torch.equal(st, xl.to(torch.int64)) and torch.equal(out, x)
                and all(zlib.decompress(cb[r, : cl[r]].tobytes(), -15)
                        == rows_np[r, : lens_np[r]].tobytes()
                        for r in range(len(cl))))
        res[name] = {"rows": list(x.shape), "lengths": lens_np.tolist(),
                     "links_route": dc.links_route(x.shape[1]),
                     "links_max_abs_err": max_err(prev, pref),
                     "parse_max_abs_err": e, "parse_plain_ms": plain_ms,
                     "ntok": nt.tolist(), "round_trip": back,
                     "parse_ms": cuda_ms(
                         lambda: dc.deflate_parse_greedy(x, xl, pref), 3),
                     "links_ms": cuda_ms(lambda: dc.deflate_links(x, xl), 3)}
        if not back:
            raise AssertionError(f"device-rule streams of {name} did not "
                                 "decode back")
        if name == "segment_rows":
            for r, want in ends.items():
                got = match_ends(tok[r, : int(nt[r])].tolist())
                if not want <= got:
                    raise AssertionError(f"segment row {r}: no matches "
                                         f"ending at {sorted(want - got)}")
        else:
            p = torch.arange(x.shape[1], device="cuda")
            far = int((p - prev[2])[prev[2] >= 0].max())
            res[name]["row_2_farthest_link"] = far
            if far <= dc.LINK_TILE:
                raise AssertionError("tile row 2: no link across its zero "
                                     "tile")
    res["max_abs_err"] = errs
    return res


# csrc/deflate_encode.cu's kernels of the tiled route (rows past 64 KiB):
# the histograms (mode 0), each tile's bits, each row's tile offsets, each
# tile's fields
TILED_EMIT = ("deflate_hist_kernel", "deflate_emit_sums_kernel",
              "deflate_emit_scan_kernel", "deflate_emit_tiles_kernel")

# csrc/deflate_encode.cu's kernels that an emit wrapper's launch takes (the
# histograms, the tables, the bits), as kernel_name() gives them
EMIT_PREFIXES = ("deflate_hist_kernel", "deflate_tables_kernel",
                 "deflate_emit_")

# {emit wrapper: {route: the kernels its launches took there}}, from the
# traces of phase 3's tile rows, the serving path and phases 17 and 18
EMIT_TRACED = {"deflate_emit": {}, "deflate_emit_tuple": {}}


def emit_traced(wrapper: str, trace: dict, route: str) -> list:
    """The tables' and emit's kernels of `trace` (traced() of a run in
    which `wrapper` alone launched them), checked to be `route`'s ("row":
    the row emit kernel and no tiles' fields; "tiled": the reverse) and
    kept in EMIT_TRACED."""
    names = sorted(k for k in trace["kernels"] if k.startswith(EMIT_PREFIXES))
    tiled = "deflate_emit_tiles_kernel" in names
    # the row emit is a template (its fragment mode): deflate_emit_kernel<..>
    row = any(k.startswith("deflate_emit_kernel") for k in names)
    if tiled != (route == "tiled") or tiled == row:
        raise AssertionError(f"{wrapper}: not the {route} route's kernels "
                             f"in its trace: {names}")
    EMIT_TRACED[wrapper].setdefault(route, set()).update(names)
    return names


def tile_bounds(tokens: list, order: str, skip: int) -> list:
    """The first bit of each tile after the first, from the row's aligned
    word, as csrc/deflate_encode.cu's tiled emit places them: the row's
    byte skip, the header's bits (the tables in `order`) and every token's
    bits before the tile."""
    dc = deflate_coder
    llen, dlen, head = dc.block_tables(tokens, 0, order)
    _, lb, _, db = dc.token_fields(tokens, llen, dlen)
    before = torch.cumsum(lb + db, 0)[dc.TOKEN_TILE - 1 :: dc.TOKEN_TILE]
    base = 8 * skip + sum(b for _, b in head)
    return [base + int(b) for b in before[: (len(tokens) - 1)
                                          // dc.TOKEN_TILE]]


def token_tile_rows(seed: int) -> dict:
    """{width: (raw rows (B, n) u8 on the card, zero past each length,
    lengths, {order: tokens (B, n) i32, ntok (B,)}, the rows' names)} for
    the tiled histograms and emit (csrc/deflate_encode.cu past 64 KiB): at
    65,537 bytes (64 KiB + 1) text, zeros, b"ab" and random bytes, among
    64 text rows the first whose tiles in the tuple order start on a word
    boundary somewhere (a tile's last field ending a word), the first
    whose tiles in the C++ rule's order do, and the first whose tiles
    start only inside words in both, and 4,097 random bytes as 4,097
    literals (a last tile of one token); at 128 KiB text, zeros, b"ab" and
    random bytes.  Tokens: the device rule's greedy parse ("tuple") and
    the C++ rule's lazy parse at max_chain 8 ("std"), by the kernels (each
    held against its plain version elsewhere); every row's tiles past its
    tokens exit at once."""
    dc = deflate_coder
    rng = np.random.default_rng(seed)
    out = {}
    for n in (dc.STAGE_MAX + 1, 2 * dc.STAGE_MAX):
        pitch = dc.encode_cap(n)
        text = np.frombuffer(text_corpus(66 * n, seed), np.uint8)
        base = [text[:n], np.zeros(n, np.uint8),
                np.resize(np.frombuffer(b"ab", np.uint8), n),
                rng.integers(0, 256, n, np.uint8)]
        names = ["text", "zero", "ab", "random"]
        cand = np.stack([text[(k + 1) * n : (k + 2) * n] for k in range(64)])
        x = torch.from_numpy(np.stack(base + list(cand))).cuda()
        xl = torch.full((len(x),), n, dtype=torch.int32, device="cuda")
        prev = dc.deflate_links(x, xl)
        toks = {"tuple": dc.deflate_parse_greedy(x, xl, prev),
                "std": dc.deflate_parse(x, xl, prev, 8)}
        keep = list(range(len(base)))
        if n == dc.STAGE_MAX + 1:
            # the candidates' tile starts in each order, at the byte skip
            # each kind's row takes below (rows 4-6 of the group: the
            # wrapper's rows start pitch bytes apart)
            kinds = (("word_boundary_tuple", 4, ("tuple",), True),
                     ("word_boundary_std", 5, ("std",), True),
                     ("inside_words", 6, ("tuple", "std"), False))
            found = {}
            for kind, at, orders, on in kinds:
                for k in range(len(base), len(x)):
                    hit = [0 in {b % 32 for b in tile_bounds(
                        toks[o][0][k, : int(toks[o][1][k])].tolist(), o,
                        at * pitch % 4)} for o in orders]
                    if (all(hit) if on else not any(hit)):
                        found[kind] = k
                        break
            if len(found) != len(kinds):
                raise AssertionError(f"no text rows with tiles on and off "
                                     f"word boundaries: {found}")
            keep += [found[kind] for kind, _, _, _ in kinds]
            names += [f"text_{kind}" for kind, _, _, _ in kinds]
        rows = x[keep].clone()
        lens = xl[keep].clone()
        tokens = {o: (t[0][keep].clone(), t[1][keep].clone())
                  for o, t in toks.items()}
        if n == dc.STAGE_MAX + 1:
            one = rng.integers(0, 256, dc.TOKEN_TILE + 1, np.uint8)
            row = torch.zeros((1, n), dtype=torch.uint8, device="cuda")
            row[0, : len(one)] = torch.from_numpy(one).cuda()
            tok = torch.zeros((1, n), dtype=torch.int32, device="cuda")
            tok[0, : len(one)] = row[0, : len(one)].to(torch.int32)
            nt = torch.tensor([len(one)], dtype=torch.int32, device="cuda")
            rows = torch.cat([rows, row])
            lens = torch.cat([lens, nt])
            tokens = {o: (torch.cat([t[0], tok]), torch.cat([t[1], nt]))
                      for o, t in tokens.items()}
            names.append("one_token_tile")
        out[n] = (rows, lens, tokens, names)
    return out


def emit_at_skips(order: str, tok, nt, n: int):
    """One row's tokens (1, n) emitted four times by the C entry of
    `order` (tpz_deflate_emit_tuple, or tpz_deflate_emit in mode 0) into
    one buffer at an odd pitch from an offset of 1 byte, so that the four
    rows start at byte skips 1, 0, 3, 2 of their words -> (their streams,
    their lengths, the skips)."""
    dc = deflate_coder
    b = 4
    pitch = dc.encode_cap(n) + 1
    toks, nts = tok.repeat(b, 1).contiguous(), nt.repeat(b).contiguous()
    buf = torch.zeros(b * pitch + 8, dtype=torch.uint8, device="cuda")
    clens = torch.empty(b, dtype=torch.int32, device="cuda")
    scratch = torch.empty(dc._emit_scratch_bytes(b, n), dtype=torch.uint8,
                          device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    at = buf.data_ptr() + 1
    if order == "tuple":
        err = dc._lib("emit_tuple")(toks.data_ptr(), nts.data_ptr(), b, n, at,
                                    pitch, clens.data_ptr(),
                                    scratch.data_ptr(), stream)
    else:
        err = dc._lib("emit")(toks.data_ptr(), nts.data_ptr(), toks.data_ptr(),
                              nts.data_ptr(), b, n, 0, at, pitch,
                              clens.data_ptr(), scratch.data_ptr(), stream)
    _build.check(err, f"deflate emit ({order}) at byte skips")
    cl = clens.tolist()
    data = buf.cpu().numpy()
    return ([data[1 + r * pitch : 1 + r * pitch + cl[r]].tobytes()
             for r in range(b)], cl, [(at + r * pitch) % 4 for r in range(b)])


# emit_tiles_check's launches: (wrapper, order, mode)
EMIT_TILE_RUNS = (("deflate_emit_tuple", "tuple", 0),
                  ("deflate_emit", "std", 0), ("deflate_emit", "std", 1))


def emit_tile_call(name: str, x, xl, tok, nt, mode: int):
    """A closure of one launch of the emit wrapper `name` on token rows."""
    dc = deflate_coder
    if name == "deflate_emit_tuple":
        return lambda: dc.deflate_emit_tuple(x, xl, tok, nt)
    return lambda: dc.deflate_emit(x, xl, tok, nt, mode)


def emit_tiles_traces(seed: int) -> dict:
    """--trace emit_tiles:SEED: traced() of each launch of emit_tiles_check
    on token_tile_rows(SEED), after one launch: {"n:order_mode_m": the
    trace}."""
    out = {}
    for n, (x, xl, tokens, _) in token_tile_rows(seed).items():
        for name, order, mode in EMIT_TILE_RUNS:
            call = emit_tile_call(name, x, xl, *tokens[order], mode)
            call()
            out[f"{n}:{order}_mode_{mode}"] = traced(
                call, TILED_EMIT + ("deflate_emit_kernel",))
    return out


def emit_tiles_check(seed: int) -> dict:
    """csrc/deflate_encode.cu's tiled histograms and emit (rows past 64
    KiB) on token_tile_rows(): both orders (tpz_deflate_emit_tuple; and
    tpz_deflate_emit, dynamic and fixed), each exact against
    deflate_emit_plain, every stream inflated back by inflate.cu and by
    zlib, the tiled route's kernels asserted by a trace (taken in a fresh
    process, emit_tiles_traces, where this one's recorded no device event
    at all); the first text row once more at every byte skip of its word
    (emit_at_skips), each stream the plain one."""
    dc = deflate_coder
    res, errs = {}, {"deflate_emit": 0, "deflate_emit_tuple": 0,
                     "inflate": 0}
    tiled = TILED_EMIT
    groups = token_tile_rows(seed)
    child = None
    for n, (x, xl, tokens, names) in groups.items():
        rec = {"rows": names, "width": n}
        for name, order, mode in EMIT_TILE_RUNS:
            tok, nt = tokens[order]
            call = emit_tile_call(name, x, xl, tok, nt, mode)
            got = call()
            ref, plain_ms = timed(
                lambda: dc.deflate_emit_plain(x, xl, tok, nt, mode, order))
            e = max(max_err(a, c) for a, c in zip(got, ref))
            errs[name] = max(errs[name], e)
            out, st = dc.inflate_batch(*got, n)
            iref = dc.inflate_batch_plain(*got, n)
            errs["inflate"] = max(errs["inflate"], max_err(out, iref[0]),
                                  max_err(st, iref[1]))
            comp, clens = (a.cpu().numpy() for a in got)
            rows, lens = x.cpu().numpy(), xl.tolist()
            back = (torch.equal(st, xl.to(torch.int64))
                    and torch.equal(out, x)
                    and all(zlib.decompress(comp[r, : clens[r]].tobytes(), -15)
                            == rows[r, : lens[r]].tobytes()
                            for r in range(len(lens))))
            tr = traced(call, tiled + ("deflate_emit_kernel",))
            key = f"{order}_mode_{mode}"
            if not tr["kernels"]:   # the profiler lost the whole trace here
                if child is None:
                    child = trace_in_child(f"emit_tiles:{seed}")
                tr = {**child[f"{n}:{key}"], "in_child": True}
            rec[key] = {"max_abs_err": e, "round_trip": back,
                        "ntok": nt.tolist(), "stream_bytes": clens.tolist(),
                        "plain_ms": plain_ms, "ms": cuda_ms(call, 3),
                        "kernels_ms": tr["expected_ms"]}
            if not back:
                raise AssertionError(f"tiled emit {key} at {n}: streams did "
                                     "not decode back")
            # the fixed mode counts no histograms
            if set(tr["missing"]) != {"deflate_emit_kernel"} | (
                    {tiled[0]} if mode else set()):
                raise AssertionError(f"tiled emit {key} at {n}: not the tiled "
                                     f"route's kernels: {tr['missing']}")
            emit_traced(name, tr, "tiled")
        res[str(n)] = rec
    x, xl, tokens, names = groups[dc.STAGE_MAX + 1]
    skips = {}
    for order in ("tuple", "std"):
        tok, nt = (t[:1].contiguous() for t in tokens[order])
        want = dc.deflate_emit_plain(x[:1], xl[:1], tok, nt, 0, order)
        want = want[0][0, : int(want[1][0])].cpu().numpy().tobytes()
        streams, cl, at = emit_at_skips(order, tok, nt, x.shape[1])
        e = int(any(st != want for st in streams))
        errs["deflate_emit_tuple" if order == "tuple" else "deflate_emit"] = \
            max(errs["deflate_emit_tuple" if order == "tuple"
                     else "deflate_emit"], e)
        skips[order] = {"skips": at, "stream_bytes": cl, "max_abs_err": e}
        if sorted(at) != [0, 1, 2, 3] or e or any(
                zlib.decompress(st, -15) != x[0].cpu().numpy().tobytes()
                for st in streams):
            raise AssertionError(f"tiled emit ({order}) at byte skips {at}: "
                                 "streams differ from the plain one")
    res["byte_skips"] = skips
    res["max_abs_err"] = errs
    return res


def deflate_kernel_check(x, xl, n: int):
    """csrc/deflate_encode.cu and csrc/inflate.cu against their plain
    versions: on the mixed rows (rows of 0 to 12 bytes, empty rows, runs,
    periods) with zero, b"ab" and random rows added, at max_chain 1, 8 and
    128 in the dynamic and fixed modes and stored; on 40 KiB rows whose
    repeats lie 32,767 to 32,769 back (the first two taken, the third not);
    on 128 KiB rows (stored blocks of 65,535 + 65,535 + 2, and rows of
    65,535 and 65,536 bytes); the links on links_edge_check()'s rows at
    both routes' edges; the decoder also on deflate_garbage(), on
    the mixed streams at an out_cap under their lengths and on
    inflate_edge_streams() (codes of 12-15 bits, stored blocks after
    Huffman blocks across the staged tiles), each of those decoded to its
    bytes.  Emits its kernels line; returns each launch's max_abs_err."""
    rng = np.random.default_rng(SEED + 17)
    extra = np.stack([np.zeros(n), np.resize([97, 98], n),
                      rng.integers(0, 256, n), rng.integers(0, 256, n)])
    rows = torch.cat([x, torch.from_numpy(extra.astype(np.uint8)).cuda()])
    lens = torch.cat([xl, torch.full((4,), n, dtype=torch.int32,
                                     device="cuda")])
    res = {"mixed": deflate_check(rows, lens, DEFLATE_CHAINS)}
    far, flens = (torch.from_numpy(a).cuda()
                  for a in deflate_far_rows(SEED + 18))
    res["far"] = deflate_check(far, flens, (8, DEFLATE_PATH_CHAIN))
    tok, nt = deflate_coder.deflate_parse(
        far, flens, deflate_coder.deflate_links(far, flens), 8)
    dists = [sorted({t & 0xFFFF for t in tok[r, : int(nt[r])].tolist()
                     if t >= 256}) for r in range(len(DEFLATE_GAPS))]
    res["far"]["far_distances"] = [d[-3:] for d in dists]
    if not (DEFLATE_GAPS[0] in dists[0] and DEFLATE_GAPS[1] in dists[1]
            and DEFLATE_GAPS[2] not in dists[2]
            and max(max(d, default=0) for d in dists) <= 32768):
        raise AssertionError(f"deflate repeats at the window's edge taken "
                             f"or refused wrong: {res['far']}")
    big, blens = (torch.from_numpy(a).cuda()
                  for a in deflate_big_rows(SEED + 19))
    res["big"] = deflate_check(big, blens, (DEFLATE_PATH_CHAIN,))
    res["links_edges"] = links_edge_check(SEED + 23)
    res["table_rows"] = table_rows_check(SEED + 24)
    res["xla_rule"] = xla_rule_check(SEED + 25)
    res["segments"] = segments_check(SEED + 26)
    res["emit_tiles"] = emit_tiles_check(SEED + 28)
    comp, clens = res["big"]["streams"]["stored"]
    want = [5 * max(1, -(-int(ln) // 65535)) + int(ln) for ln in blens]
    if clens.tolist() != want:
        raise AssertionError(f"stored blocks of {blens.tolist()} bytes took "
                             f"{clens.tolist()}, not {want}")
    garbage = deflate_garbage(SEED + 20)
    gx, gl = padded(garbage, max(map(len, garbage)))
    mixed, mlens = res["mixed"]["streams"]["mode_0_chain_128"]
    edges = inflate_edge_streams(SEED + 21)
    ex, el = padded([s for s, _ in edges], max(len(s) for s, _ in edges))
    decode = {"garbage": (gx, gl, 8192), "short_cap": (mixed, mlens, n // 2),
              "edges": (ex, el, 1 << 16)}
    errs = {}
    for name, (s, sl, cap) in decode.items():
        out, status = deflate_coder.inflate_batch(s, sl, cap)
        (oref, sref), plain_ms = timed(
            lambda: deflate_coder.inflate_batch_plain(s, sl, cap))
        e = max(max_err(out, oref), max_err(status, sref))
        errs["inflate"] = max(errs.get("inflate", 0), e)
        res[f"decode_{name}"] = {
            "rows": list(s.shape), "out_cap": cap, "max_abs_err": e,
            "statuses": {str(int(k)): int(v) for k, v in zip(
                *torch.unique(status, return_counts=True))}
            if name == "short_cap" else status.tolist()[-4:]
            if name == "garbage" else status.tolist(),
            "plain_ms": plain_ms}
        if name == "edges" and not (
                status.tolist() == [len(raw) for _, raw in edges]
                and all(out[r, : len(raw)].cpu().numpy().tobytes() == raw
                        for r, (_, raw) in enumerate(edges))):
            raise AssertionError("inflate.cu did not decode the edge "
                                 f"streams to their bytes: {status}")
    multi = [zlib.decompress(s, -15) for s in garbage[-4:]]
    got = res["decode_garbage"]["statuses"]
    if got != [len(m) for m in multi]:
        raise AssertionError(f"zlib's multi-block streams decoded to {got}, "
                             f"not {[len(m) for m in multi]}")
    for rec in (res["mixed"], res["far"], res["big"], res["links_edges"],
                res["table_rows"], res["xla_rule"], res["segments"],
                res["emit_tiles"]):
        for k, e in rec["max_abs_err"].items():
            errs[k] = max(errs.get(k, 0), e)
        rec.pop("streams", None)
    emit("kernels", kernel="deflate", **res)
    if any(errs.values()):
        raise AssertionError(f"deflate kernels disagree with their plain "
                             f"versions: {res}")
    return errs


def deflate_bound(name: str, args, out) -> dict:
    """bound() of one deflate launch at its own inputs: each reads the
    valid bytes or tokens or stream bytes it needs and the lengths, and
    writes its output (prev, the tokens, the streams, the decoded rows)
    and its lengths."""
    if name == "inflate":
        streams, lens = args[:2]
        nbytes = (int(lens.clamp(max=streams.shape[1]).sum())
                  + 4 * lens.numel() + out[0].numel() + 8 * out[1].numel())
    elif name in ("deflate_emit", "deflate_emit_tuple"):
        lens, ntok = args[1], args[3]
        nbytes = (4 * int(ntok.sum()) + 8 * lens.numel()
                  + int(out[1].sum()) + 4 * out[1].numel())
    else:
        lens = args[1]
        valid = int(lens.sum()) + 4 * lens.numel()
        nbytes = valid + 4 * args[0].numel() + (
            4 * int(out[1].sum()) + 4 * out[1].numel()
            if name in ("deflate_parse", "deflate_parse_greedy") else 0)
    return bound(nbytes)


def deflate_against_plain(calls, rows: list) -> dict:
    """The deflate path's launches held, exact, against their plain
    versions: the encoder's on its first 8 rows cut to DEFLATE_PLAIN_BYTES
    (the plain parse and tables take a Python step a token): each kernel
    on the cut equal to the plain version, and the path's own links on the
    cut's causal prefix (below length - 2 a link depends on no later byte)
    and on every row whole too; inflate.cu on `rows` whole streams of its
    own launch, the
    kernel's own rows equal too.  Times of each kernel at the path's shape
    and on the cut, of the plain version on the cut; the bound at the
    path's shape."""
    dc = deflate_coder
    for name in DEFLATE_NAMES:
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} launches on "
                                 "the path, expected 1")
    launch = {name: calls[name][0] for name in DEFLATE_NAMES}
    (largs, _, prev) = launch[DEFLATE_NAMES[0]]
    (pargs, _, _) = launch["deflate_parse"]
    (eargs, _, _) = launch["deflate_emit"]
    blocks, lens = largs[:2]
    max_chain, mode = pargs[3], eargs[4]
    cut = blocks[:8, :DEFLATE_PLAIN_BYTES].contiguous()
    clen = lens[:8].clamp(max=DEFLATE_PLAIN_BYTES).contiguous()
    pref, links_plain_ms = timed(lambda: dc.deflate_links_plain(cut, clen))
    causal = DEFLATE_PLAIN_BYTES - 2
    # and the path's own links, every row whole (the plain links are one
    # sort a row)
    links_err = max(max_err(dc.deflate_links(cut, clen), pref),
                    max_err(prev[:8, :causal], pref[:, :causal]),
                    max_err(prev, dc.deflate_links_plain(blocks, lens)))
    tref, parse_plain_ms = timed(
        lambda: dc.deflate_parse_plain(cut, clen, pref, max_chain))
    parse_err = max(max_err(a, c) for a, c in zip(
        dc.deflate_parse(cut, clen, pref, max_chain), tref))
    eref, emit_plain_ms = timed(
        lambda: dc.deflate_emit_plain(cut, clen, *tref, mode))
    emit_err = max(max_err(a, c) for a, c in zip(
        dc.deflate_emit(cut, clen, *tref, mode), eref))
    (iargs, ikw, iout) = launch["inflate"]
    pick = torch.tensor(rows, device="cuda")
    icut = (iargs[0][pick].contiguous(), iargs[1][pick].contiguous(),
            *iargs[2:])
    iref, inflate_plain_ms = timed(lambda: dc.inflate_batch_plain(*icut))
    inflate_err = max(max(max_err(a, c) for a, c in zip(
        dc.inflate_batch(*icut), iref)), max(
        max_err(a[pick], c) for a, c in zip(iout, iref)))
    errs = {DEFLATE_NAMES[0]: links_err, "deflate_parse": parse_err,
            "deflate_emit": emit_err, "inflate": inflate_err}
    if any(errs.values()):
        raise AssertionError(f"deflate kernels disagree with their plain "
                             f"versions on the path's inputs: {errs}")
    plain = {"plain_inputs": list(cut.shape), "plain_rows": list(range(8))}
    cut_args = {DEFLATE_NAMES[0]: (cut, clen),
                "deflate_parse": (cut, clen, pref, max_chain),
                "deflate_emit": (cut, clen, *tref, mode), "inflate": icut}
    plain_ms = {DEFLATE_NAMES[0]: links_plain_ms,
                "deflate_parse": parse_plain_ms,
                "deflate_emit": emit_plain_ms, "inflate": inflate_plain_ms}
    res = {}
    for name in DEFLATE_NAMES:
        args, kw, out = launch[name]
        run = getattr(dc, "inflate_batch" if name == "inflate" else name)
        res[name] = {
            "inputs": [list(a.shape) for a in args if torch.is_tensor(a)],
            "max_abs_err": errs[name],
            **(plain if name != "inflate" else
               {"plain_inputs": list(icut[0].shape), "plain_rows": rows}),
            "ms": cuda_ms(lambda: run(*args, **kw), 3),
            "ms_at_plain_inputs": cuda_ms(lambda: run(*cut_args[name]), 3),
            "plain_ms": plain_ms[name], **deflate_bound(name, args, out)}
    res["deflate_parse"]["max_chain"] = max_chain
    return res


def deflate_wide(data: bytes):
    """The deflate path at DEFLATE_WIDE_BLOCK blocks (tpuzip's block_size
    knob past 64 KiB): compress and decompress of `data`, the bytes back,
    its four launches run, its links on the tiled route; the links held
    exact against their plain version on every row whole and on the path's
    first 8 rows cut to DEFLATE_PLAIN_BYTES (the tiled kernel called
    there directly); its tables with the emit (the tiled route) held exact
    against their plain version on the path's first 8 whole rows of
    tokens, the path's own streams there too -> (the path's launch counts,
    the tiled links' row: times at the path's shape and on the cut, the
    bound; the emit's check)."""
    dc = deflate_coder
    with counted_run() as (calls, counts):
        blob = tpuzip_torch.compress(data, codec="deflate",
                                     block_size=DEFLATE_WIDE_BLOCK)
        back = tpuzip_torch.decompress(blob)
    need(counts, {"deflate_links": 1, "deflate_parse": 1, "deflate_emit": 1,
                  "inflate": 1}, "deflate wide")
    if back != data or counts["deflate_links_shared"]:
        raise AssertionError(f"deflate at {DEFLATE_WIDE_BLOCK}-byte blocks: "
                             f"round trip {back == data}, {counts}")
    (args, kw, prev), = calls["deflate_links"]
    (eargs, _, eout), = calls["deflate_emit"]
    calls.clear()
    ecut = tuple(a[:8].contiguous() for a in eargs[:4])
    eref, emit_plain_ms = timed(
        lambda: dc.deflate_emit_plain(*ecut, eargs[4]))
    emit_err = max(max(max_err(a, c) for a, c in zip(
                       dc.deflate_emit(*ecut, eargs[4]), eref)),
                   max(max_err(a[:8], c) for a, c in zip(eout, eref)))
    if emit_err:
        raise AssertionError("the tables with the emit disagree with their "
                             f"plain version at the wide path: {emit_err}")
    del eargs, eout, eref
    blocks, lens = args[:2]
    cut = blocks[:8, :DEFLATE_PLAIN_BYTES].contiguous()
    clen = lens[:8].clamp(max=DEFLATE_PLAIN_BYTES).contiguous()
    pref, plain_ms = timed(lambda: dc.deflate_links_plain(cut, clen))
    err = max(max_err(dc.deflate_links_tiled(cut, clen), pref),
              max_err(prev, dc.deflate_links_plain(blocks, lens)))
    if err:
        raise AssertionError(f"the tiled links disagree with their plain "
                             f"version at the wide path: {err}")
    return counts, {
        "inputs": [list(a.shape) for a in args if torch.is_tensor(a)],
        "route": dc.links_route(blocks.shape[1]), "max_abs_err": err,
        "plain_inputs": list(cut.shape), "plain_rows": list(range(8)),
        "ms": cuda_ms(lambda: dc.deflate_links_tiled(blocks, lens), 3),
        "ms_at_plain_inputs": cuda_ms(
            lambda: dc.deflate_links_tiled(cut, clen), 3),
        "plain_ms": plain_ms, **deflate_bound("deflate_links", args, prev)}, {
        "plain_inputs": [list(a.shape) for a in ecut[:2]],
        "plain_rows": list(range(8)), "plain_ms": emit_plain_ms,
        "max_abs_err": emit_err}


def phase_deflate(smi: str):
    """Phase 17: the deflate codec (tpuzip's C++ encoder, dynamic blocks at
    max_chain DEFLATE_PATH_CHAIN, tpuzip's defaults): compress and
    decompress of the 64 MiB corpus at 64 KiB blocks, then
    decompress(to_device=True), then the wide path (deflate_wide: 8 MiB
    at 128 KiB blocks, the tiled links and emit).  The bytes round-trip
    both ways;
    the four launches run (deflate_encode.cu's links, parse and tables+emit, and
    inflate.cu); 8 blocks' streams inflate by zlib to the blocks; each
    launch held against its plain version (deflate_against_plain); MB/s,
    ratio, peak memory and a device trace of each direction in a fresh
    process (the emit's row route asserted by it)."""
    data = text_corpus(CORPUS_BYTES, SEED)
    tpuzip_torch.decompress(tpuzip_torch.compress(data[: 4 * BLOCK],
                                                  codec="deflate"))
    blob, calls, counts, t_enc, t_dec, peak_enc, peak_dec = round_trip(
        data, codec="deflate")
    need(counts, dict.fromkeys(DEFLATE_NAMES, 1), "deflate")
    if blob[4:6] != bytes([5, 0]):
        raise AssertionError(f"deflate: codec id {blob[4]}, flags {blob[5]}")
    blocks_np, lens_np = blk.chunk(data, BLOCK)
    streams = lz_streams(blob)
    nb = len(streams)
    rows = sorted({0, 1, 2, nb // 3, nb // 2, 2 * nb // 3, nb - 2, nb - 1})
    for i in rows:
        if zlib.decompress(streams[i], -15) != \
                blocks_np[i, : lens_np[i]].tobytes():
            raise AssertionError(f"deflate block {i}: zlib inflates it to "
                                 "other bytes")
    kernels = deflate_against_plain(calls, rows)
    calls.clear()
    with counted_run() as (calls, dev_counts):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, olens, orig = tpuzip_torch.decompress(blob, to_device=True)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        peak_dev = torch.cuda.max_memory_allocated()
    calls.clear()
    need(dev_counts, {"inflate": 1}, "deflate to_device")
    trace = trace_in_child("deflate")
    emit_traced("deflate_emit", trace["encode"], "row")
    wide_counts, wide_links, wide_emit = deflate_wide(
        data[:DEFLATE_WIDE_BYTES])
    # the kernels line's error of the emit: the deflate path's and the wide
    # path's (the tiled route)
    kernels["deflate_emit"] = {**kernels["deflate_emit"], "max_abs_err": max(
        kernels["deflate_emit"]["max_abs_err"], wide_emit["max_abs_err"])}
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(-1, BLOCK)
    if not (torch.equal(out.cpu(), x) and orig == len(data)
            and list(olens) == lens_np.tolist()):
        raise AssertionError("deflate decompress(to_device=True) did not "
                             "give the blocks")
    emit("deflate", corpus_bytes=len(data), block_size=BLOCK, blocks=nb,
         max_chain=DEFLATE_PATH_CHAIN, mode="dynamic",
         container_bytes=len(blob), ratio=len(blob) / len(data),
         launches=counts, zlib_blocks=rows,
         encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec,
         encode_kernel_mb_s=len(data) / 1e3 / sum(
             kernels[k]["ms"] for k in DEFLATE_NAMES[:3]),
         decode_kernel_mb_s=len(data) / 1e3 / kernels["inflate"]["ms"],
         peak_device_bytes={"encode": peak_enc, "decode": peak_dec,
                            "decode_to_device": peak_dev},
         to_device={"launches": dev_counts,
                    "decode_mb_s": len(data) / 1e6 / t_dev},
         wide={"launches": wide_counts, "deflate_links": wide_links,
               "deflate_emit": wide_emit},
         kernels=kernels, trace=trace, card=smi)
    return counts, dev_counts, wide_counts, {**kernels,
                                             "deflate_links": wide_links}


ZLIB_BYTES = 8 << 20        # the zlib phase's input: one stream, one row


def phase_zlib(smi: str):
    """Phase 18: the zlib wrapper (codecs.zlib_: tpuzip's CLI -f zlib) on
    ZLIB_BYTES of the corpus, one raw stream of one row (tpuzip's device
    rule on the tiled links route, its parse in segments): compress, then
    decompress, on cuda; Python's zlib reads the stream back, and the port
    reads zlib.compress(data, 6).  The device rule's launches run and the
    C++ rule's do not; each launch on the one 8 MiB row is held exact
    against its plain version on the same inputs and timed alone (CUDA
    events), with the peak device memory it takes beyond what is held
    before it; the tuple tables with the emit split by kernel from one
    traced launch (the tiled histograms, the tables, each tile's bits, the
    tile offsets, each tile's fields: the tiled route asserted, the row
    emit kernel not launched); MB/s of each direction (the inflate of one
    stream is one serial chain).  Returns (the launches, each launch's
    max_abs_err)."""
    data = text_corpus(CORPUS_BYTES, SEED)[:ZLIB_BYTES]
    zlib_.decompress(zlib_.compress(data[:4096]), 4096)
    with counted_run() as (calls, counts):
        t0 = time.perf_counter()
        z = zlib_.compress(data)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = zlib_.decompress(z, len(data))
        t_dec = time.perf_counter() - t0
    need(counts, {"deflate_links": 1, "deflate_parse_greedy": 1,
                  "deflate_emit_tuple": 1, "inflate": 1}, "zlib")
    if back != data or zlib.decompress(z) != data or any(
            counts[k] for k in ("deflate_links_shared", "deflate_parse",
                                "deflate_emit")):
        raise AssertionError(f"zlib: round trip {back == data}, {counts}")
    dc = deflate_coder
    plains = {"deflate_links": dc.deflate_links_plain,
              "deflate_parse_greedy": lambda *a: dc.deflate_parse_plain(
                  *a, 1, greedy=True),
              "deflate_emit_tuple": lambda *a: dc.deflate_emit_plain(
                  *a, 0, "tuple"),
              "inflate": dc.inflate_batch_plain}
    tup = lambda v: v if isinstance(v, tuple) else (v,)   # noqa: E731
    errs, plain_ms, launch_ms, peak = {}, {}, {}, {}
    for name, plain in plains.items():
        (args, kw, out), = calls[name]
        ref, plain_ms[name] = timed(lambda: plain(*args, **kw))
        errs[name] = max(max_err(a, c) for a, c in zip(tup(out), tup(ref)))
        del ref
        run = getattr(*WRAPPERS[name])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run(*args, **kw)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
        launch_ms[name] = cuda_ms(lambda: run(*args, **kw), 3)
    # the tables with the emit on the tiled route: each kernel's device ms
    # alone, from one traced launch on the same row in a fresh process (the
    # profiler lost events late in this one); the row emit not launched
    split = trace_in_child("zlib_emit")
    if split["missing"] != ["deflate_emit_kernel"]:
        raise AssertionError("zlib: the tuple tables with the emit did not "
                             f"take the tiled route: {split}")
    emit_traced("deflate_emit_tuple", split, "tiled")
    calls.clear()
    if any(errs.values()):
        raise AssertionError("zlib: the device rule's launches on one "
                             "8 MiB row disagree with their plain versions: "
                             f"{errs}")
    ref = zlib.compress(data, 6)
    t0 = time.perf_counter()
    theirs = zlib_.decompress(ref, len(data))
    t_ref = time.perf_counter() - t0
    if theirs != data:
        raise AssertionError("zlib_.decompress misread zlib.compress's "
                             "stream")
    emit("zlib", bytes=len(data), stream_bytes=len(z),
         ratio=len(z) / len(data), launches={k: v for k, v in counts.items()
                                             if v},
         encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec, max_abs_err=errs,
         plain_ms=plain_ms, launch_ms=launch_ms, launch_peak_bytes=peak,
         emit_tuple_kernels_ms={
             "tables": split["expected_ms"]["Counted"],
             **{k: split["expected_ms"][k] for k in TILED_EMIT}},
         encode_kernels_mb_s=len(data) / 1e3 / sum(
             launch_ms[k] for k in ("deflate_links", "deflate_parse_greedy",
                                    "deflate_emit_tuple")),
         zlib_level_6={"ratio": len(ref) / len(data),
                       "decode_mb_s": len(data) / 1e6 / t_ref}, card=smi)
    return counts, errs


STREAM_FRAME_BLOCKS = (1 << 16, 1 << 22)   # compress_frame's block_max
STREAM_BYTES = 8 << 20      # each streaming adapter's input
STREAM_FORMATS = ("lz4f", "zlib", "ari", "bwt", "rle", "mtf", "dc")
LINKED_BYTES = 1 << 19      # the linked frame's content
XXH_PLAIN_BYTES = 1 << 16   # the xxh32 plain checks' rows
HISTORY_PLAIN_BYTES = 16 << 10   # the history check's block, after 64 KiB
INFLATE_PLAIN_BYTES = 1 << 20    # the inflate_ends check's zlib stream
FRAGMENT_WIDE = 1 << 17          # rows of the fragments' tiled-route check


def linked_block(window: bytes, chunk: bytes) -> bytes:
    """An LZ4 block of a linked frame: oracle.lz4.compress_block's greedy
    single-probe parse over chunk, its table primed with the last 64 KiB
    of window, so that matches reach back into the blocks before it
    (liblz4 links a frame's blocks so by default)."""
    hist = window[-lz4_frame.WINDOW:]
    src, base = hist + chunk, len(hist)
    n = len(src)
    table = {}
    for p in range(max(0, base - 3)):
        table[olz4._hash(int.from_bytes(src[p : p + 4], "little"))] = p
    out = bytearray()
    anchor = i = base
    limit = max(n - olz4.MF_LIMIT, base)
    while i < limit:
        seq = src[i : i + 4]
        h = olz4._hash(int.from_bytes(seq, "little"))
        cand = table.get(h, -1)
        table[h] = i
        if cand >= 0 and i - cand <= 0xFFFF and src[cand : cand + 4] == seq:
            m, c, end = i + 4, cand + 4, n - olz4.LAST_LITERALS
            while m < end and src[m] == src[c]:
                m += 1
                c += 1
            olz4._emit_sequence(out, src, anchor, i - anchor, i - cand, m - i)
            i = anchor = m
        else:
            i += 1
    out.append(min(n - anchor, 15) << 4)
    olz4._emit_len_ext(out, n - anchor, 15)
    out += src[anchor:n]
    return bytes(out)


def linked_frame(data: bytes, block_max: int, block_checksum: bool) -> bytes:
    """data as a linked LZ4 frame (FLG bit 5 clear) of linked_block()s, a
    block stored where it does not shrink, with its content checksum and,
    if asked, its block checksums (oracle xxh32 on the host)."""
    flg = (1 << 6) | (int(block_checksum) << 4) | (1 << 2)
    desc = bytes([flg, {v: k for k, v in olz4._BD_MAX_SIZES.items()}
                  [block_max] << 4])
    out = bytearray(struct.pack("<I", olz4.MAGIC) + desc
                    + bytes([(oxxh32.xxh32(desc) >> 8) & 0xFF]))
    for k in range(0, len(data), block_max):
        chunk = data[k : k + block_max]
        comp = linked_block(data[:k], chunk)
        body, flag = (comp, 0) if len(comp) < len(chunk) else (chunk, 1 << 31)
        out += struct.pack("<I", len(body) | flag) + body
        if block_checksum:
            out += struct.pack("<I", oxxh32.xxh32(body))
    out += struct.pack("<II", 0, oxxh32.xxh32(data))
    return bytes(out)


def with_block_checksums(frame: bytes) -> bytes:
    """An independent frame of compress_frame's with FLG bit 4 set and
    each block's xxh32 (oracle, host) after it."""
    desc = bytes([frame[4] | 1 << 4, frame[5]])
    out = bytearray(frame[:4] + desc
                    + bytes([(oxxh32.xxh32(desc) >> 8) & 0xFF]))
    i = 7
    while True:
        (blen,) = struct.unpack_from("<I", frame, i)
        n = blen & 0x7FFFFFFF
        out += frame[i : i + 4 + n]
        i += 4 + n
        if blen == 0:
            return bytes(out + frame[i:])
        out += struct.pack("<I", oxxh32.xxh32(frame[i - n : i]))


def stream_write(fmt: str, data: bytes, **kw) -> bytes:
    """data through tpuzip_torch.open(f, "wb", format=fmt) in three writes
    that split its blocks."""
    f = io.BytesIO()
    w = tpuzip_torch.open(f, "wb", format=fmt, **kw)
    cuts = (0, 1000, len(data) // 2 + 7, len(data))
    for a, b in zip(cuts, cuts[1:]):
        w.write(data[a:b])
    w.close()
    return f.getvalue()


def stream_read(fmt: str, blob: bytes) -> bytes:
    """blob through tpuzip_torch.open(f, "rb", format=fmt) in reads of 7
    bytes, 1 MiB and the rest."""
    r = tpuzip_torch.open(io.BytesIO(blob), "rb", format=fmt)
    return r.read(7) + r.read(1 << 20) + r.read()


def nested(data: bytes) -> bytes:
    """data through an LZ4 frame writer nested over a zlib writer, read back
    through the readers nested the same way."""
    f = io.BytesIO()
    z = tpuzip_torch.open(f, "wb", format="zlib")
    w = tpuzip_torch.open(z, "wb", format="lz4f")
    w.write(data[:333])
    w.write(data[333:])
    w.close()
    z.close()
    r = tpuzip_torch.open(tpuzip_torch.open(io.BytesIO(f.getvalue()), "rb",
                                            format="zlib"),
                          "rb", format="lz4f")
    return r.read()


def xxh32_chain(n: int) -> int:
    """Dependent steps of a row of n bytes: each lane's n / 16 stripes, then
    the tail's words and bytes."""
    return n // 16 + (n % 16) // 4 + n % 4


def streams_against_plain(calls) -> dict:
    """The streams phase's new launches held, exact, against their plain
    versions, on the cuts the module note names; each timed at the path's
    shape."""
    res = {}
    # xxh32 batch: the content checksum of the 64 MiB frame (one row) cut
    # to its first XXH_PLAIN_BYTES, and the linked frame's block checksums
    # on 4 whole rows of their launch
    content = max((c for c in calls["xxh32_batch"] if c[0][0].shape[0] == 1),
                  key=lambda c: c[0][0].shape[1])
    blocksums = max(calls["xxh32_batch"], key=lambda c: c[0][0].shape[0])
    rows, lens = content[0][:2]
    cut = rows[:, :XXH_PLAIN_BYTES].contiguous()
    cut_lens = lens.clamp(max=XXH_PLAIN_BYTES)
    ref, plain_ms = timed(lambda: kxxh32.xxh32_batch_plain(cut, cut_lens))
    err = max_err(kxxh32.xxh32_batch(cut, cut_lens), ref)
    brows, blens = blocksums[0][:2]
    nb = brows.shape[0]
    pick = torch.tensor(sorted({0, nb // 2, nb - 2, nb - 1} - {-1, -2}),
                        device="cuda")
    bref = kxxh32.xxh32_batch_plain(brows[pick], blens[pick])
    err = max(err, max_err(blocksums[2][pick], bref))
    n = int(lens[0])
    ms = cuda_ms(lambda: kxxh32.xxh32_batch(rows, lens), 3)
    res["xxh32_batch"] = {
        "inputs": [list(rows.shape)], "plain_inputs": list(cut.shape),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "ns_a_step": ms * 1e6 / xxh32_chain(n),
        "block_checksums": {
            "inputs": list(brows.shape), "plain_rows": pick.tolist(),
            "ms": cuda_ms(lambda: kxxh32.xxh32_batch(brows, blens), 3)},
        **bound(n + 4)}
    # xxh32 stripes: the writer's first batch from the seed's lanes, cut
    (args, kw, _) = calls["xxh32_stripes"][0]
    state0 = Xxh32Stream(device="cuda").state   # the seed's lanes
    data = args[1]
    sc = data[:XXH_PLAIN_BYTES].contiguous()
    got, want = state0.clone(), state0.clone()
    kxxh32.xxh32_stripes(got, sc, sc.numel() // 16)
    _, s_plain_ms = timed(lambda: kxxh32.xxh32_stripes_plain(
        want, sc, sc.numel() // 16))
    st = state0.clone()
    ms = cuda_ms(lambda: kxxh32.xxh32_stripes(st, data, args[2]), 3)
    res["xxh32_stripes"] = {
        "inputs": [list(data.shape)], "plain_inputs": list(sc.shape),
        "max_abs_err": max_err(got, want), "ms": ms,
        "plain_ms": s_plain_ms, "ns_a_step": ms * 1e6 / args[2],
        **bound(16 * args[2] + 32)}
    # the history mode: a HISTORY_PLAIN_BYTES block linked to the 64 KiB
    # before it; the path's own launches (the linked frame's blocks) timed
    text = text_corpus(CORPUS_BYTES, SEED)
    window = text[: lz4_frame.WINDOW]
    chunk = text[lz4_frame.WINDOW : lz4_frame.WINDOW + HISTORY_PLAIN_BYTES]
    comp = linked_block(window, chunk)
    crow = torch.frombuffer(bytearray(comp), dtype=torch.uint8).cuda()[None]
    clen = torch.tensor([len(comp)], dtype=torch.int32, device="cuda")
    hist = torch.frombuffer(bytearray(window), dtype=torch.uint8).cuda()[None]
    got = lz4_coder.lz4_decode_batch(crow, clen, HISTORY_PLAIN_BYTES, hist)
    ref, h_plain_ms = timed(lambda: lz4_coder.lz4_decode_batch_plain(
        crow, clen, HISTORY_PLAIN_BYTES, hist))
    err = max(max_err(a, b) for a, b in zip(got, ref))
    if ref[0][0].cpu().numpy().tobytes() != chunk:
        raise AssertionError("streams: the history check's block did not "
                             "decode to its bytes")
    (hargs, hkw, hout), = [c for c in calls["lz4_decode_history"]
                           if c[0][3].shape[1] == lz4_frame.WINDOW][:1]
    # both modes on one block of the independent 64 KiB frame (its matches
    # within the block), the history mode after 64 KiB of zeros, in turns
    (bargs, _, _) = min((c for c in calls["lz4_decode"]
                         if c[0][0].shape[0] == CORPUS_BYTES // BLOCK),
                        key=lambda c: c[0][0].shape[1])
    one = (bargs[0][:1].contiguous(), bargs[1][:1].contiguous(), bargs[2])
    zeros = torch.zeros((1, lz4_frame.WINDOW), dtype=torch.uint8,
                        device="cuda")
    modes = {}
    for mode in ("history", "block", "block", "history"):
        modes.setdefault(mode, []).append(cuda_ms(
            (lambda: lz4_coder.lz4_decode_history(*one, zeros))
            if mode == "history" else
            (lambda: lz4_coder.lz4_decode_batch(*one)), 3))
    res["lz4_decode_history"] = {
        "inputs": [list(hargs[0].shape), list(hargs[3].shape)],
        "plain_inputs": [list(crow.shape), list(hist.shape)],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: lz4_coder.lz4_decode_history(*hargs), 3),
        "one_block_in_turns_ms": modes, "plain_ms": h_plain_ms,
        **bound(int(hargs[1][0]) + hargs[3].numel() + 2 * int(hout[1][0]))}
    # the fragment mode: the zlib writer's first batch on 4 whole rows, and
    # in turns against the stream instance on the same tokens
    (fargs, fkw, fout) = calls["deflate_emit_fragment"][0]
    nb = fargs[0].shape[0]
    pick = torch.tensor(sorted({0, nb // 2, nb - 2, nb - 1}), device="cuda")
    fcut = tuple(a[pick].contiguous() for a in fargs[:4])
    ref, f_plain_ms = timed(lambda: deflate_coder.deflate_emit_plain(
        *fcut, fargs[4], fragment=True))
    got = deflate_coder.deflate_emit_fragment(*fcut, fargs[4])
    err = max(max(max_err(a, b) for a, b in zip(got, ref)),
              max(max_err(a[pick], b) for a, b in zip(fout, ref)))
    turns = {}
    for name in ("deflate_emit_fragment", "deflate_emit", "deflate_emit",
                 "deflate_emit_fragment"):
        run = getattr(deflate_coder, name)
        turns.setdefault(name, []).append(
            cuda_ms(lambda: run(*fargs), 3))
    # the tiled route's fragments (rows past 64 KiB) and the stored mode's,
    # each spliced into one stream that zlib reads
    wide = text[: 2 * FRAGMENT_WIDE] + bytes(FRAGMENT_WIDE)
    wrows = torch.frombuffer(bytearray(wide), dtype=torch.uint8).cuda(
        ).reshape(3, FRAGMENT_WIDE)
    wlens = torch.tensor([FRAGMENT_WIDE, FRAGMENT_WIDE - 777, FRAGMENT_WIDE],
                         dtype=torch.int32, device="cuda")
    tok = deflate_coder.deflate_parse(wrows, wlens, deflate_coder.deflate_links(
        wrows, wlens), 64)
    for mode, toks in ((0, tok), (1, tok), (2, (None, None))):
        got = deflate_coder.deflate_emit_fragment(wrows, wlens, *toks, mode)
        ref = deflate_coder.deflate_emit_plain(wrows, wlens, *toks, mode,
                                               fragment=True)
        err = max(err, max(max_err(a, b) for a, b in zip(got, ref)))
        splice = b"".join(got[0][k, : int(got[1][k])].cpu().numpy().tobytes()
                          for k in range(3))
        want = b"".join(wide[k * FRAGMENT_WIDE : k * FRAGMENT_WIDE + n]
                        for k, n in enumerate(wlens.tolist()))
        if zlib.decompressobj(-15).decompress(splice + b"\x03\x00") != want:
            raise AssertionError(f"streams: mode {mode}'s fragments do not "
                                 "splice")
    res["deflate_emit_fragment"] = {
        "inputs": [list(fargs[0].shape)], "plain_inputs": list(fcut[0].shape),
        "plain_rows": pick.tolist(), "max_abs_err": err,
        "also_exact_on": f"3 rows of {FRAGMENT_WIDE} bytes (the tiled "
        "route) in the three modes",
        "ms": sum(turns["deflate_emit_fragment"]) / 2,
        "in_turns_ms": turns, "plain_ms": f_plain_ms,
        **deflate_bound("deflate_emit", fargs, fout)}
    # the inflate's ends: a zlib writer's stream of INFLATE_PLAIN_BYTES
    # with 5 bytes after its Adler-32; the reader's 8 MiB stream timed,
    # against the inflate without ends in turns
    z = stream_write("zlib", text[:INFLATE_PLAIN_BYTES]) + b"after"
    zrow = torch.frombuffer(bytearray(z[2:]), dtype=torch.uint8).cuda()[None]
    zlen = torch.tensor([len(z) - 2], dtype=torch.int32, device="cuda")
    cap = 2 * INFLATE_PLAIN_BYTES
    got = deflate_coder.inflate_ends(zrow, zlen, cap)
    ref, i_plain_ms = timed(lambda: deflate_coder.inflate_batch_plain(
        zrow, zlen, cap, with_ends=True))
    err = max(max_err(a, b) for a, b in zip(got, ref))
    if int(ref[2][0]) != len(z) - 2 - 4 - 5:
        raise AssertionError(f"streams: the inflate's end {int(ref[2][0])} "
                             "is not the stream's")
    big = max(calls["inflate_ends"], key=lambda c: c[0][0].shape[1])
    iargs = big[0]
    turns = {}
    for name in ("inflate_ends", "inflate_batch", "inflate_batch",
                 "inflate_ends"):
        run = getattr(deflate_coder, name)
        turns.setdefault(name, []).append(cuda_ms(lambda: run(*iargs), 1))
    res["inflate_ends"] = {
        "inputs": [list(iargs[0].shape)], "plain_inputs": list(zrow.shape),
        "max_abs_err": err, "ms": sum(turns["inflate_ends"]) / 2,
        "in_turns_ms": turns, "plain_ms": i_plain_ms,
        **bound(int(iargs[1][0]) + int(big[2][1][0]) + 16)}
    return res


def phase_streams(smi: str):
    """Phase 19: the LZ4 frame and tpuzip.io's streaming adapters, through
    the entry points a user calls.  codecs.lz4_frame.compress_frame and
    decompress_frame of the 64 MiB corpus at block_max 64 KiB (1024
    blocks) and 4 MiB (16: the dense encoder's tiled links); a linked
    frame of LINKED_BYTES (its matches reaching into the blocks before,
    liblz4's default) with block checksums, and compress_frame's 64 KiB
    frame of its first LINKED_BYTES with block checksums added, each read
    back and by the oracle; STREAM_BYTES of the corpus through
    tpuzip_torch.open's writer and reader of each format (lz4f, zlib and
    the five framed codecs), written in three pieces and read in three;
    the zlib reader on 8 MiB of zeros (its output grown from 64 KiB) and
    on a stream with bytes after its Adler-32.  Every path round-trips.
    The new launches held exact against their plain versions
    (streams_against_plain): xxh32_batch on the content row cut to
    XXH_PLAIN_BYTES and on 4 whole rows of the block checksums' launch,
    xxh32_stripes on the writer's first batch cut to XXH_PLAIN_BYTES,
    lz4_decode's history mode on a HISTORY_PLAIN_BYTES block after 64
    KiB, the fragment emit on 4 whole rows of the zlib writer's batch,
    the inflate's ends on a zlib stream of INFLATE_PLAIN_BYTES.  Returns
    (the launches, the kernels' records)."""
    data = text_corpus(CORPUS_BYTES, SEED)
    head = data[:LINKED_BYTES]
    t0 = time.perf_counter()
    linked = linked_frame(head, 1 << 16, True)
    indep = with_block_checksums(lz4_frame.compress_frame(head))
    build_s = time.perf_counter() - t0
    for fmt in STREAM_FORMATS:   # warm each path outside the counts
        stream_read(fmt, stream_write(fmt, data[:5000]))
    zeros = bytes(STREAM_BYTES)
    zeros_z = zlib.compress(zeros, 9)
    after = zlib.compress(data[:100_000], 6) + b"ignored"
    res, sizes = {}, {}
    with counted_run() as (calls, counts):
        for bm in STREAM_FRAME_BLOCKS:
            t0 = time.perf_counter()
            frame = lz4_frame.compress_frame(data, bm)
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = lz4_frame.decompress_frame(frame)
            t_dec = time.perf_counter() - t0
            if back != data:
                raise AssertionError(f"streams: the {bm}-byte-block frame "
                                     "did not round-trip")
            res[f"frame_{bm}"] = {"ratio": len(frame) / len(data),
                                  "encode_mb_s": len(data) / 1e6 / t_enc,
                                  "decode_mb_s": len(data) / 1e6 / t_dec}
        for name, frame in (("linked", linked), ("block_checksums", indep)):
            t0 = time.perf_counter()
            back = lz4_frame.decompress_frame(frame)
            res[name] = {"decode_mb_s": len(head) / 1e6
                         / (time.perf_counter() - t0)}
            if back != head:
                raise AssertionError(f"streams: the {name} frame misread")
        src = data[:STREAM_BYTES]
        for fmt in STREAM_FORMATS:
            t0 = time.perf_counter()
            blob = stream_write(fmt, src)
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = stream_read(fmt, blob)
            t_dec = time.perf_counter() - t0
            if back != src:
                raise AssertionError(f"streams: {fmt} did not round-trip")
            sizes[fmt] = blob
            res[fmt] = {"ratio": len(blob) / len(src),
                        "encode_mb_s": len(src) / 1e6 / t_enc,
                        "decode_mb_s": len(src) / 1e6 / t_dec}
        t0 = time.perf_counter()
        if stream_read("zlib", zeros_z) != zeros:
            raise AssertionError("streams: the zlib reader misread zeros")
        res["zlib_zeros"] = {"stream_bytes": len(zeros_z), "decode_mb_s":
                             len(zeros) / 1e6 / (time.perf_counter() - t0)}
        if stream_read("zlib", after) != data[:100_000]:
            raise AssertionError("streams: bytes after the Adler-32 misread")
        if nested(head) != head:
            raise AssertionError("streams: lz4f over zlib misread")
    if zlib.decompress(sizes["zlib"]) != data[:STREAM_BYTES] or any(
            olz4.decompress_frame(f) != head for f in (
                linked, indep, stream_write("lz4f", head))):
        raise AssertionError("streams: zlib or the oracle misread a frame")
    need(counts, {"xxh32_batch": 2, "xxh32_stripes": 1, "lz4_dense_words": 1,
                  "lz4_links_tiled": 1, "lz4_dense_words_links": 1, "lz4_dense_words_parse": 2,
                  "lz4_decode": 3, "lz4_decode_history": 1,
                  "lz4_encode": 1, "deflate_links_shared": 1,
                  "deflate_parse": 1, "deflate_emit_fragment": 1,
                  "inflate_ends": 2, "ari_encode": 1,
                  "ari_decode_unindexed": 1, "rle_encode": 1,
                  "rle_decode": 1, "mtf": 2, "dc_decode": 1}, "streams")
    if counts["deflate_emit"] or counts["inflate"]:
        raise AssertionError(f"streams: a stream instance ran: {counts}")
    kernels = streams_against_plain(calls)
    calls.clear()
    bad = {k: v["max_abs_err"] for k, v in kernels.items()
           if v["max_abs_err"]}
    if bad:
        raise AssertionError(f"streams: kernels disagree with their plain "
                             f"versions: {bad}")
    emit("streams", paths=res, launches={k: v for k, v in counts.items()
                                         if v},
         frames_built_s=build_s, kernels=kernels,
         cuts={"xxh32_batch": f"the content row's first {XXH_PLAIN_BYTES} "
               "bytes; 4 whole rows of the block checksums",
               "xxh32_stripes": f"the first {XXH_PLAIN_BYTES} bytes of the "
               "writer's first batch",
               "lz4_decode_history": f"a {HISTORY_PLAIN_BYTES}-byte block "
               f"after {lz4_frame.WINDOW} bytes of history",
               "deflate_emit_fragment": "4 whole rows of the zlib writer's "
               f"first batch; 3 rows of {FRAGMENT_WIDE} bytes in each mode",
               "inflate_ends": f"the zlib writer's stream of "
               f"{INFLATE_PLAIN_BYTES} bytes, 5 bytes after its Adler-32"},
         card=smi)
    return counts, kernels


TRACED = {"bwtdc": (("ari_encode_kernel",),
                    ("ari_decode_kernel", "dc_decode_kernel")),
          "apm": (("bin_encode_kernel",), ("bin_decode_kernel",)),
          "lz4": (("lz4_encode_kernel",), ("lz4_decode_kernel",)),
          "rle": (("rle_encode_kernel",), ("rle_decode_kernel",)),
          "serve_lz4": (("lz4_dense_words_kernel",
                         "lz4_dense_words_parse_kernel"),
                        ("lz4_decode_kernel",)),
          "serve_rle": (("rle_encode_kernel",), ("rle_decode_kernel",)),
          "serve_deflate": (("deflate_links_shared_kernel",
                             "deflate_best_kernel",
                             "deflate_segment_maps_kernel",
                             "deflate_segment_chain_kernel",
                             "deflate_segment_emit_kernel",
                             "deflate_hist_kernel", "TupleShared",
                             "deflate_emit_kernel"), ("inflate_kernel",)),
          "lz4p": (("lz4_encode_kernel", "lz4p_pack_kernel"),
                   ("lz4p_decode_kernel",)),
          "serve_lz4p": (("lz4_dense_words_kernel",
                          "lz4_dense_words_parse_kernel", "lz4p_pack_kernel"),
                         ("lz4p_decode_kernel",)),
          "lz4_chain": (("lz4_chain_links_shared_kernel",
                         "lz4_chain_best_kernel", "lz4_chain_parse_kernel"),
                        ("lz4_decode_kernel",)),
          "deflate": (("deflate_links_shared_kernel",
                       "deflate_parse_kernel",
                       "deflate_tables_kernel", "deflate_emit_kernel"),
                      ("inflate_kernel",))}


def trace_in_child(codec: str) -> dict:
    """traced() of one compress and one decompress of the corpus through
    `codec` (or trace_child's other traces), in a fresh process (this
    script with --trace): in this process the profiler lost kernels from
    traces taken late in the run
    (a bwtdc decode without its ari decode kernel, apm traces with no
    device events at all), while a fresh process traced every kernel of
    repeated runs."""
    out = subprocess.run([sys.executable, __file__, "--trace", codec],
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"the {codec} trace failed:\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def trace_child(codec: str) -> int:
    """--trace CODEC: traced() of one compress and one decompress of the
    corpus through CODEC; --trace lz4_chain: lz4 at CHAIN_PATH_DEPTH;
    --trace zlib_emit: trace_zlib_emit(); --trace emit_tiles:SEED:
    emit_tiles_traces(SEED)."""
    if codec.startswith("serve"):
        return trace_serving(codec)
    if codec == "zlib_emit":
        return trace_zlib_emit()
    if codec.startswith("emit_tiles:"):
        print(json.dumps(emit_tiles_traces(int(codec.split(":")[1]))))
        return 0
    data = text_corpus(CORPUS_BYTES, SEED)
    block = BWT_BLOCK if codec == "bwtdc" else BLOCK
    kw = {"codec": codec, "block_size": block}
    if codec == "lz4_chain":
        cfg = Config()
        cfg.codec.lz4.max_chain = CHAIN_PATH_DEPTH
        kw = {"codec": "lz4", "block_size": block, "config": cfg}
    tpuzip_torch.decompress(tpuzip_torch.compress(data[: 2 * block], **kw))
    blob = tpuzip_torch.compress(data, **kw)
    enc, dec = TRACED[codec]
    print(json.dumps({
        "encode": traced(lambda: tpuzip_torch.compress(data, **kw), enc),
        "decode": traced(lambda: tpuzip_torch.decompress(blob), dec)}))
    return 0


def trace_zlib_emit() -> int:
    """--trace zlib_emit: traced() of deflate_emit_tuple on phase 18's row
    (ZLIB_BYTES of the corpus as one row, its tokens from the links and
    the greedy parse), after one launch: the tiled route's kernels, the
    tables' ("Counted") and the row emit's, which must be missing."""
    dc = deflate_coder
    data = text_corpus(CORPUS_BYTES, SEED)[:ZLIB_BYTES]
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(1, -1).cuda()
    xl = torch.tensor([len(data)], dtype=torch.int32, device="cuda")
    tok, nt = dc.deflate_parse_greedy(x, xl, dc.deflate_links(x, xl))
    dc.deflate_emit_tuple(x, xl, tok, nt)
    print(json.dumps(traced(lambda: dc.deflate_emit_tuple(x, xl, tok, nt),
                            TILED_EMIT + ("Counted", "deflate_emit_kernel"))))
    return 0


def trace_serving(path: str) -> int:
    """--trace serve: traced() of one compress_from_device and one
    decompress(to_device=True) of the serving tensor through lz4, rle and
    deflate (tpuzip's device rule); --trace serve_CODEC: through CODEC
    alone."""
    x, lens, _ = serving_tensor()
    out = {}
    for codec in (("lz4", "rle", "deflate") if path == "serve"
                  else (path[6:],)):
        tpuzip_torch.decompress(tpuzip_torch.compress_from_device(
            x[:2].contiguous(), lens[:2], codec=codec), to_device=True)
        blob = tpuzip_torch.compress_from_device(x, lens, codec=codec)
        enc, dec = TRACED[f"serve_{codec}"]
        out[codec] = {
            "encode": traced(lambda: tpuzip_torch.compress_from_device(
                x, lens, codec=codec), enc),
            "decode": traced(lambda: tpuzip_torch.decompress(
                blob, to_device=True), dec)}
    print(json.dumps(out))
    return 0


def sass_functions(nvcc: str, lib: str) -> dict:
    """{mangled kernel name: its SASS lines, addresses and encodings
    dropped} of a built library (cuobjdump -sass)."""
    text = subprocess.run([nvcc.rsplit("nvcc", 1)[0] + "cuobjdump", "-sass",
                           lib], check=True, capture_output=True, text=True,
                          timeout=120).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and "/*" in line:
            code = re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "", line)
            if code.strip():
                funcs[name].append(code.strip())
    return funcs


def ab_inputs(wanted) -> dict:
    """{kernel: {path: (args, kw)}} for each kernel of `wanted`: the one
    launch of each A/B kernel on the container paths, recorded through its
    wrapper: ari_encode_indexed at the ari, bwt, bwt_big and bwtdc paths'
    compress, ari_decode_indexed at their decompress; mtf_batch at the bwt
    and bwt_big paths' compress (encode) and decompress (decode);
    bin_encode_indexed at the bin and apm paths' compress,
    bin_decode_indexed at their decompress, and bin_apm.decode_batch at
    the apm container's without the chunk index; dc_decode_lanes at the
    bwtdc path's decompress.  And for the dot row (ari_decode.cu through
    the dot route): the ari path's decode launch and the decode of phase
    5's A/B mix.  lz4_encode / lz4_decode and rle_encode / rle_decode at
    the lz4 and rle paths; deflate_links at the deflate path's compress
    (its shared route) and on as many zero, b"ab" and random rows;
    deflate_links_wide (a DIR's keyed route, the checkout's tiled one) on
    the wide path's 128 KiB rows, as many zero rows and phase 18's one
    8 MiB row; deflate_parse_greedy (the best kernel at max_chain 1, then
    the greedy parse) on the serving tensor, as many zero and random rows
    and phase 18's 8 MiB row; deflate_emit (the
    tables and the emit) at the deflate and wide paths' compress, on those
    zero, b"ab" and random rows' tokens (the links and the parse at
    max_chain 128) and on phase 3's table_rows(); deflate_emit_tuple (the
    device rule's tables and emit) at the serving path's
    compress_from_device, on as many zero and random rows' tokens and on
    phase 18's 8 MiB row's (the greedy parse), and on phase 3's
    table_rows(); inflate_batch at the deflate path's decompress and on phase 3's
    inflate_edge_streams() and deflate_garbage(); lz4p_pack at the lz4p path's compress (runs split),
    at its serving path's compress_from_device (unsplit) and on phase 3's
    pack_edge_rows() both ways, lz4p_decode_batch at the lz4p path's
    decompress.  A path none of whose kernels is wanted is not run."""
    data = text_corpus(CORPUS_BYTES, SEED)
    out = {kernel: {} for kernel in AB_KERNELS}

    def keep(kernel, path, calls):
        (args, kw, _), = calls
        out[kernel][path] = (tuple(a.contiguous() if torch.is_tensor(a)
                                   else a for a in args), kw)

    for path, codec, block, corpus in (
            ("ari", "ari", BLOCK, data), ("bwt", "bwt", BWT_BLOCK, data),
            ("bwt_big", "bwt", BIG_BLOCK, text_corpus(BIG_BLOCK, SEED)),
            ("bwtdc", "bwtdc", BWT_BLOCK, data), ("bin", "bin", BLOCK, data),
            ("apm", "apm", BLOCK, data)):
        ari = codec != "bin" and codec != "apm"
        if not set(wanted) & ({"ari_encode", "ari_decode", "ari_decode_dot",
                               "mtf", "dc_decode"} if ari
                              else {"bin_encode", "bin_decode"}):
            continue
        with (recorded(range_coder, "ari_encode_indexed") as enc,
              recorded(bin_coder, "bin_encode_indexed") as benc,
              recorded(mtf_scan, "mtf_batch") as menc):
            blob = tpuzip_torch.compress(corpus, codec=codec,
                                         block_size=block)
        wrapper = ((range_decoder, "ari_decode_indexed") if ari
                   else (bin_coder, "bin_decode_indexed"))
        with (recorded(*wrapper) as dec,
              recorded(mtf_scan, "mtf_batch") as mdec,
              recorded(dc_scan, "dc_decode_lanes") as walk):
            if tpuzip_torch.decompress(blob) != corpus:
                raise AssertionError(f"{path} did not round-trip")
        if ari:
            keep("ari_encode", path, enc)
        else:
            keep("bin_encode", path, benc)
        if codec == "bwt":
            keep("mtf", f"{path}:encode", menc)
            keep("mtf", f"{path}:decode", mdec)
        keep(wrapper[1].replace("_indexed", ""), path, dec)
        if codec == "bwtdc":
            keep("dc_decode", path, walk)
        if codec == "apm":
            with recorded(bin_apm, "decode_batch") as flat:
                if tpuzip_torch.decompress(strip_index(blob)) != corpus:
                    raise AssertionError("apm without the index did not "
                                         "round-trip")
            keep("bin_decode", "apm_unindexed", flat)
    for codec, (coder, _, _) in LZ.items():
        if not set(wanted) & {f"{codec}_encode", f"{codec}_decode"}:
            continue
        with recorded(coder, f"{codec}_encode_batch") as enc:
            blob = tpuzip_torch.compress(data, codec=codec)
        with recorded(coder, f"{codec}_decode_batch") as dec:
            if tpuzip_torch.decompress(blob) != data:
                raise AssertionError(f"{codec} did not round-trip")
        keep(f"{codec}_encode", codec, enc)
        keep(f"{codec}_decode", codec, dec)
    if set(wanted) & {"deflate_links_wide", "deflate_parse_greedy"}:
        wide = torch.frombuffer(bytearray(data[:DEFLATE_WIDE_BYTES]),
                                dtype=torch.uint8).view(
                                    -1, DEFLATE_WIDE_BLOCK).cuda()
        wide_lens = torch.full((wide.shape[0],), DEFLATE_WIDE_BLOCK,
                               dtype=torch.int32, device="cuda")
        row = wide.view(1, -1)
        row_len = torch.tensor([row.shape[1]], dtype=torch.int32,
                               device="cuda")
        for name, rows, lens in (
                ("deflate_wide", wide, wide_lens),
                ("wide_zero", torch.zeros_like(wide), wide_lens),
                ("zlib_row", row, row_len)):
            out["deflate_links_wide"][name] = ((rows, lens), {})
        x, lens, _ = serving_tensor()
        rng = np.random.default_rng(SEED + 27)
        for name, rows, lens in (
                ("serving", x, lens),
                ("serving_zero", torch.zeros_like(x), lens),
                ("serving_random", torch.from_numpy(rng.integers(
                    0, 256, tuple(x.shape), np.uint8)).cuda(), lens),
                ("zlib_row", row, row_len)):
            out["deflate_parse_greedy"][name] = (
                (rows, lens, deflate_coder.deflate_links(rows, lens)), {})
    if set(wanted) & {"inflate", "deflate_links", "deflate_emit"}:
        with (recorded(deflate_coder, "deflate_links_shared") as links,
              recorded(deflate_coder, "deflate_emit") as emit):
            blob = tpuzip_torch.compress(data, codec="deflate")
        keep("deflate_links", "deflate", links)
        keep("deflate_emit", "deflate", emit)
        x, lens = out["deflate_links"]["deflate"][0]
        rng = np.random.default_rng(SEED + 22)
        for name, rows in (
                ("zero", torch.zeros_like(x)),
                ("ab", torch.tensor([97, 98], dtype=torch.uint8,
                                    device="cuda").repeat(
                                        x.numel() // 2).view(x.shape)),
                ("random", torch.from_numpy(rng.integers(
                    0, 256, tuple(x.shape), np.uint8)).cuda())):
            out["deflate_links"][f"deflate_{name}"] = ((rows, lens), {})
            if "deflate_emit" in wanted:
                tok = deflate_coder.deflate_parse(
                    rows, lens, deflate_coder.deflate_links(rows, lens),
                    DEFLATE_PATH_CHAIN)
                out["deflate_emit"][f"deflate_{name}"] = (
                    (rows, lens, *tok, 0), {})
        if "deflate_emit" in wanted:
            with recorded(deflate_coder, "deflate_emit") as emit:
                tpuzip_torch.compress(data[:DEFLATE_WIDE_BYTES],
                                      codec="deflate",
                                      block_size=DEFLATE_WIDE_BLOCK)
            keep("deflate_emit", "deflate_wide", emit)
            for group, (tok, nt, raw, rl, _) in table_rows(
                    SEED + 24).items():
                out["deflate_emit"][f"table_{group}"] = (
                    (raw, rl, tok, nt, 0), {})
    if "deflate_emit_tuple" in wanted:
        dc_ = deflate_coder
        x, lens, _ = serving_tensor()
        with recorded(dc_, "deflate_emit_tuple") as emit:
            tpuzip_torch.compress_from_device(x, lens, codec="deflate")
        keep("deflate_emit_tuple", "serving", emit)
        rng = np.random.default_rng(SEED + 29)
        row = x.view(1, -1)[:, :ZLIB_BYTES].contiguous()
        row_len = torch.tensor([ZLIB_BYTES], dtype=torch.int32,
                               device="cuda")
        for name, rows, ln in (
                ("serving_zero", torch.zeros_like(x), lens),
                ("serving_random", torch.from_numpy(rng.integers(
                    0, 256, tuple(x.shape), np.uint8)).cuda(), lens),
                ("zlib_row", row, row_len)):
            tok = dc_.deflate_parse_greedy(rows, ln,
                                           dc_.deflate_links(rows, ln))
            out["deflate_emit_tuple"][name] = ((rows, ln, *tok), {})
        for group, (tok, nt, raw, rl, _) in table_rows(SEED + 24).items():
            out["deflate_emit_tuple"][f"table_{group}"] = (
                (raw, rl, tok, nt), {})
    if "inflate" in wanted:
        with recorded(deflate_coder, "inflate_batch") as dec:
            if tpuzip_torch.decompress(blob) != data:
                raise AssertionError("deflate did not round-trip")
        keep("inflate", "deflate", dec)
        edges = [st for st, _ in inflate_edge_streams(SEED + 21)]
        out["inflate"]["edges"] = (
            (*padded(edges, max(map(len, edges))), 1 << 16), {})
        garbage = deflate_garbage(SEED + 20)
        out["inflate"]["garbage"] = (
            (*padded(garbage, max(map(len, garbage))), 8192), {})
    if set(wanted) & {"lz4p_pack", "lz4p_decode"}:
        with recorded(lz4p_coder, "lz4p_pack") as enc:
            blob = tpuzip_torch.compress(data, codec="lz4p")
        with recorded(lz4p_coder, "lz4p_decode_batch") as dec:
            if tpuzip_torch.decompress(blob) != data:
                raise AssertionError("lz4p did not round-trip")
        keep("lz4p_pack", "lz4p", enc)
        keep("lz4p_decode", "lz4p", dec)
        x, lens, _ = serving_tensor()
        with recorded(lz4p_coder, "lz4p_pack") as enc:
            tpuzip_torch.compress_from_device(x, lens, codec="lz4p")
        keep("lz4p_pack", "lz4p_serving", enc)
        comp, clens, n = pack_edge_rows(SEED + 16)
        for split in (True, False):
            out["lz4p_pack"][f"edges_split_{split}"] = (
                (comp, clens, n, split), {})
    if set(wanted) & {"ari_decode", "ari_decode_dot"}:
        mix = torch.from_numpy(ab_mix(128, BLOCK, SEED)).cuda()
        mix_lens = torch.full((128,), BLOCK, dtype=torch.int32,
                              device="cuda")
        mix_streams, _, mix_deltas = range_coder.ari_encode_indexed(mix,
                                                                    mix_lens)
        out["ari_decode_dot"] = {"ari": out["ari_decode"]["ari"],
                                 "mix": ((mix_streams, mix_deltas, mix_lens),
                                         {})}
    return out


AB_KERNELS = ("ari_encode", "ari_decode", "bin_decode", "mtf", "bin_encode",
              "dc_decode", "lz4_encode", "lz4_decode", "rle_encode",
              "rle_decode", "inflate", "lz4p_pack", "lz4p_decode",
              "deflate_links", "deflate_links_wide", "deflate_parse_greedy",
              "deflate_emit", "deflate_emit_tuple")
AB_SOURCE = {"rle_encode": "rle", "rle_decode": "rle",   # else the name
             "lz4p_pack": "lz4p", "lz4p_decode": "lz4p",
             "deflate_links": "deflate_encode",
             "deflate_links_wide": "deflate_encode",
             "deflate_parse_greedy": "deflate_encode",
             "deflate_emit": "deflate_encode",
             "deflate_emit_tuple": "deflate_encode"}
# an A/B kernel's functions, where they are not those whose names hold
# "<kernel>_kernel": the links' shared route; their route past 64 KiB
# (a DIR's keyed kernel, the tiled kernel and its carry, since moved into
# lz4_shared.cuh as templates); the greedy parse
# (a DIR's instance of the parse kernel, the segments' three kernels);
# tpz_deflate_emit's C++-rule tables on rows of at most 64 KiB and the row
# emit kernel; tpz_deflate_emit_tuple's tables (a DIR's TupleShared
# instance, the checkout's Counted ones) and the tiled route's kernels
AB_FUNCTIONS = {"deflate_links": ("deflate_links_shared_kernel",),
                "deflate_links_wide": ("deflate_links_kernel",
                                       "links_tiled_kernel",
                                       "links_carry_kernel"),
                "deflate_parse_greedy": ("deflate_parse_kernelILb0E",
                                         "deflate_segment_"),
                "deflate_emit": ("deflate_tables_kernelINS_11TableShared",
                                 "deflate_emit_kernel"),
                "deflate_emit_tuple": ("deflate_tables_kernelINS_11TupleShared",
                                       "deflate_tables_kernelINS_7Counted",
                                       "deflate_hist_kernel",
                                       "deflate_emit_sums_kernel",
                                       "deflate_emit_scan_kernel",
                                       "deflate_emit_tiles_kernel")}
# the A/B kernels this checkout redesigns (the wide deflate links moved into
# lz4_shared.cuh's template, and both lz4 encoders' links past their shared
# routes): every other one must keep the DIR's SASS
AB_REDESIGNED = ("deflate_links_wide", "lz4_chain", "lz4_dense")
# sources whose SASS --ab compares and does not time (no launch of theirs
# is recorded for it): deflate_encode.cu's best, lazy parse and stored
# kernels, all of the DIR's functions but the A/B kernels'
AB_SASS_ONLY = ("deflate_encode",)
# csrc/deflate_encode.cu's record in a row's scratch (SCRATCH_BYTES a row):
# the codes, their lengths and the header's bits, [from, to)
DEFLATE_RECORD = (17408, 17408 + 640 + 320 + 4)
# sources whose encoders --ab times against a DIR's at their paths' shapes
# (ab_lz4), and whose SASS it holds to the DIR's: the chained lz4
# encoder's launches and the dense one's
AB_LZ4_SOURCES = ("lz4_chain", "lz4_dense")


# the keyed links' tables as a DIR's wrapper sized them (a DIR's keyed
# route, before the tiled one; tools/step_clocks.py's copy of that kernel
# too): 2^slots_log slots of KEY_SLOT bytes, twice the hashes a row can
# hold, one table a row or a pool within KEYED_POOL_BYTES
KEY_SLOT = 8
KEYED_POOL_BYTES = 1 << 30


def keyed_slots_log(n: int) -> int:
    return max(6, min(deflate_coder.HASH_BITS + 1,
                      (2 * max(n, 1) - 1).bit_length()))


def keyed_table_count(b: int, n: int) -> int:
    return max(1, min(b, KEYED_POOL_BYTES // (KEY_SLOT << keyed_slots_log(n))))


def ab_entry(lib, kernel: str):
    """The typed C entry point of `kernel` in a build.  An MTF build exports
    tpz_mtf_chunked (with its scratch) since the chunked redesign, and
    tpz_mtf before it.  The dot row's old build is a DIR's
    ari_decode_dot.cu, its new one the checkout's ari_decode.cu (the dot
    route since that source was removed)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if kernel == "mtf":
        kernel = "mtf_chunked" if hasattr(lib, "tpz_mtf_chunked") else "mtf"
    if kernel == "ari_decode_dot" and not hasattr(lib, "tpz_ari_decode_dot"):
        kernel = "ari_decode"
    fn = getattr(lib, f"tpz_{kernel}")
    fn.argtypes = {
        "ari_encode": [vp, vp, ci, ci, vp, ci, vp, vp, ci, ci, ci, vp],
        "ari_decode": [vp, vp, vp, ci, ci, ci, vp, ci, ci, vp],
        "ari_decode_dot": [vp, vp, vp, ci, ci, ci, vp, ci, ci, vp],
        "dc_decode": [vp, vp, vp, ci, ci, vp, vp, vp, vp, vp],
        "bin_decode": [vp, vp, vp, ci, ci, ci, vp, ci, ci, ci, vp],
        "bin_encode": [vp, vp, ci, ci, vp, ci, vp, vp, ci, ci, ci, ci, vp],
        "mtf": [vp, vp, ci, ci, vp, ci, vp],
        "mtf_chunked": [vp, vp, ci, ci, vp, vp, ci, vp],
        "lz4_encode": [vp, vp, ci, ci, vp, ci, vp, vp, ci, ci, vp],
        "lz4_decode": [vp, vp, ci, ci, vp, ci, vp, vp],
        "rle_encode": [vp, vp, ci, ci, vp, ci, vp, vp],
        "rle_decode": [vp, vp, ci, ci, vp, ci, vp, vp],
        "inflate": [vp, vp, ci, ci, vp, ci, vp, vp],
        "lz4p_pack": [vp, vp, ci, ci, vp, ci, vp, ci, vp],
        "lz4p_decode": [vp, vp, ci, ci, vp, ci, vp, vp],
        "deflate_emit": [vp, vp, vp, vp, ci, ci, ci, vp, ci, vp, vp,
                         vp],
        "deflate_emit_tuple": [vp, vp, ci, ci, vp, ci, vp, vp, vp]}[kernel]
    fn.restype = ci
    return fn


def ab_launchers(libs: dict, kernel: str, args, kw) -> tuple:
    """({build: a closure that launches that build once into new outputs
    and returns them}, the work's steps: the longest row's symbols, bits,
    walked runs, stream bytes (rle decode) or sequences (lz4 decode)) for
    one recorded launch of `kernel`; libs: {build: its CDLL}."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if kernel == "ari_encode":
        blocks, lens = args[:2]
        knobs = (kw.get("increment", args[2] if len(args) > 2 else 8),
                 kw.get("threshold", args[3] if len(args) > 3 else 1 << 13))
        b, n = blocks.shape
        cap, nc = range_coder.encode_cap(n), -(-n // range_decoder.CHUNK_STEPS)

        def make(lib):
            fn = ab_entry(lib, kernel)

            def run():
                out = (torch.zeros((b, cap), dtype=torch.uint8, device="cuda"),
                       torch.empty(b, dtype=torch.int32, device="cuda"),
                       torch.empty((b, nc), dtype=torch.int32, device="cuda"))
                _build.check(fn(blocks.data_ptr(), lens.data_ptr(), b, n,
                                out[0].data_ptr(), cap, out[1].data_ptr(),
                                out[2].data_ptr(), nc, *knobs, stream()),
                             "tpz_ari_encode")
                return out
            return run
        steps = int(lens.max())
    elif kernel in ("ari_decode", "ari_decode_dot"):
        streams, deltas, lens = args[:3]
        nc = kw.get("nc") or deltas.shape[1]

        def make(lib):
            fn = ab_entry(lib, kernel)

            def run():
                out = torch.empty((streams.shape[0],
                                   nc * range_decoder.CHUNK_STEPS),
                                  dtype=torch.uint8, device="cuda")
                _build.check(fn(
                    streams.data_ptr(),
                    None if deltas is None else deltas.data_ptr(),
                    lens.data_ptr(), streams.shape[0], streams.shape[1], nc,
                    out.data_ptr(), *KNOBS[0], stream()), "tpz_ari_decode")
                return (out,)
            return run
        steps = int(lens.max())
    elif kernel == "mtf":
        blocks, lens = args[:2]
        decode = int(kw.get("decode", False))
        b, n = blocks.shape

        def make(lib):
            fn = ab_entry(lib, kernel)
            chunked = hasattr(lib, "tpz_mtf_chunked")
            scratch = torch.empty(
                b * -(-n // lib.tpz_mtf_chunk_bytes()) * 256 if chunked
                else 0, dtype=torch.uint8, device="cuda")

            def run():
                out = torch.empty((b, n), dtype=torch.uint8, device="cuda")
                tail = (scratch.data_ptr(),) if chunked else ()
                _build.check(fn(blocks.data_ptr(), lens.data_ptr(), b, n,
                                out.data_ptr(), *tail, decode, stream()),
                             "tpz_mtf")
                return (out,)
            return run
        steps = int(lens.max())
    elif kernel == "bin_encode":
        blocks, lens = args[:2]
        knobs = tuple(int(k) for k in args[2:5])
        b, n = blocks.shape
        cap, nc = bin_coder.encode_cap(8 * n), -(-8 * n // bin_coder.CHUNK)

        def make(lib):
            fn = ab_entry(lib, kernel)

            def run():
                out = (torch.zeros((b, cap), dtype=torch.uint8, device="cuda"),
                       torch.empty(b, dtype=torch.int32, device="cuda"),
                       torch.empty((b, nc), dtype=torch.int32, device="cuda"))
                _build.check(fn(blocks.data_ptr(), lens.data_ptr(), b, n,
                                out[0].data_ptr(), cap, out[1].data_ptr(),
                                out[2].data_ptr(), nc, *knobs, stream()),
                             "tpz_bin_encode")
                return out
            return run
        steps = 8 * int(lens.max())
    elif kernel == "dc_decode":
        vals, first, lengths = args
        b, t = vals.shape

        def make(lib):
            fn = ab_entry(lib, kernel)

            def run():
                out = torch.empty((3, b, t), dtype=torch.int32, device="cuda")
                err = torch.empty(b, dtype=torch.int32, device="cuda")
                _build.check(fn(vals.data_ptr(), first.data_ptr(),
                                lengths.data_ptr(), b, t, out[0].data_ptr(),
                                out[1].data_ptr(), out[2].data_ptr(),
                                err.data_ptr(), stream()), "tpz_dc_decode")
                return out, err
            return run
        # the runs of the longest walk (a column of T past a walk's end is
        # no run)
        steps = int((make(libs["new"])()[0][1] > 0).sum(1).max())
    elif kernel in ("lz4_encode", "rle_encode"):
        blocks, lens = args[:2]
        b, n = blocks.shape
        lz4 = kernel == "lz4_encode"
        cap = lz4_coder.encode_cap(n) if lz4 else rle_coder.encode_cap(n)
        hl = lz4_coder.resolve_hash_log(args[2] if len(args) > 2 else 16)
        ntab = lz4_coder.table_count(b, hl)
        tables = torch.empty(ntab << hl if lz4 else 0, dtype=torch.int32,
                             device="cuda")

        def make(lib):
            fn = ab_entry(lib, kernel)

            def run():
                out = (torch.zeros((b, cap), dtype=torch.uint8, device="cuda"),
                       torch.empty(b, dtype=torch.int32, device="cuda"))
                tail = (tables.data_ptr(), ntab, hl) if lz4 else ()
                _build.check(fn(blocks.data_ptr(), lens.data_ptr(), b, n,
                                out[0].data_ptr(), cap, out[1].data_ptr(),
                                *tail, stream()), f"tpz_{kernel}")
                return out
            return run
        steps = int(lens.max())
    elif kernel in ("lz4_decode", "rle_decode", "lz4p_decode", "inflate"):
        comp, clens, out_cap = args[:3]
        b, w = comp.shape
        # inflate's output rows are zeroed by its caller
        alloc = torch.zeros if kernel == "inflate" else torch.empty

        def make(lib):
            fn = ab_entry(lib, kernel)

            def run():
                out = (alloc((b, out_cap), dtype=torch.uint8, device="cuda"),
                       torch.empty(b, dtype=torch.int64, device="cuda"))
                _build.check(fn(comp.data_ptr(), clens.data_ptr(), b, w,
                                out[0].data_ptr(), out_cap, out[1].data_ptr(),
                                stream()), f"tpz_{kernel}")
                return out
            return run
        # the longest row's stream bytes (rle), sequences (lz4: each stream
        # of the path ends in a literal run after its matches; lz4p: its
        # S) or the longest stream's symbols (inflate)
        rows, lens = comp.cpu().numpy(), clens.cpu().numpy().clip(0, w)
        if kernel == "rle_decode":
            steps = int(lens.max())
        elif kernel == "lz4_decode":
            steps = max(len(lz4_offsets(rows[r, : lens[r]].tobytes())) + 1
                        for r in range(b))
        elif kernel == "lz4p_decode":
            steps = max(int(rows[r, :4].view("<u4")[0]) if lens[r] >= 8
                        else 0 for r in range(b))
        else:
            r = int(lens.argmax())
            steps = inflate_symbols(rows[r, : lens[r]].tobytes())
    elif kernel in ("deflate_links", "deflate_links_wide"):
        blocks, lens = args[:2]
        b, n = blocks.shape
        vp, ci = ctypes.c_void_p, ctypes.c_int

        def make(lib):
            # the build's route at this width: shared up to 64 KiB where
            # the build has it, else tiled (with its scratch) or keyed
            # (with its tables, as the keyed wrapper sized them)
            tables = None
            if (hasattr(lib, "tpz_deflate_links_shared")
                    and deflate_coder.links_route(n) == "shared"):
                fn, tail, extra = lib.tpz_deflate_links_shared, [], ()
            elif hasattr(lib, "tpz_deflate_links_tiled"):
                size = lib.tpz_deflate_links_tiled_scratch
                size.argtypes, size.restype = [ci, ci], ctypes.c_longlong
                tables = torch.empty(size(b, n), dtype=torch.uint8,
                                     device="cuda")
                fn, tail, extra = lib.tpz_deflate_links_tiled, [vp], (
                    tables.data_ptr(),)
            else:
                slog, ntab = keyed_slots_log(n), keyed_table_count(b, n)
                tables = torch.empty(ntab * (KEY_SLOT << slog),
                                     dtype=torch.uint8, device="cuda")
                fn, tail, extra = lib.tpz_deflate_links, [vp, ci, ci], (
                    tables.data_ptr(), ntab, slog)
            fn.argtypes = [vp, vp, ci, ci, vp, *tail, vp]
            fn.restype = ci

            def run():
                prev = torch.empty((b, n), dtype=torch.int32, device="cuda")
                _build.check(fn(blocks.data_ptr(), lens.data_ptr(), b, n,
                                prev.data_ptr(), *extra, stream()),
                             "tpz_deflate_links")
                return (prev,)
            run.tables = tables   # the scratch, alive as long as the closure
            return run
        # the longest row's positions
        steps = int(lens.max())
    elif kernel == "deflate_parse_greedy":
        blocks, lens, prev = args[:3]
        b, n = blocks.shape
        vp, ci = ctypes.c_void_p, ctypes.c_int

        def make(lib):
            fn = lib.tpz_deflate_parse_greedy
            # since the parse runs in segments, it takes their scratch
            size = getattr(lib, "tpz_deflate_parse_scratch", None)
            if size is not None:
                size.argtypes, size.restype = [ci, ci], ctypes.c_longlong
            fn.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp] + (
                [vp, vp] if size is not None else [vp])
            fn.restype = ci

            def run():
                tok = torch.zeros((b, n), dtype=torch.int32, device="cuda")
                nt = torch.empty(b, dtype=torch.int32, device="cuda")
                best_at = torch.empty((b, n), dtype=torch.int32,
                                      device="cuda")
                scratch = [] if size is None else [torch.empty(
                    size(b, n), dtype=torch.uint8, device="cuda")]
                _build.check(fn(blocks.data_ptr(), lens.data_ptr(),
                                prev.data_ptr(), b, n, 1, tok.data_ptr(),
                                nt.data_ptr(), best_at.data_ptr(),
                                *(t.data_ptr() for t in scratch), stream()),
                             "tpz_deflate_parse_greedy")
                return tok, nt
            return run
        # the longest row's tokens
        steps = int(deflate_coder.deflate_parse_greedy(blocks, lens,
                                                       prev)[1].max())
    elif kernel in ("deflate_emit", "deflate_emit_tuple"):
        blocks, lens, tokens, ntok = args[:4]
        mode = args[4] if kernel == "deflate_emit" else 0
        b, n = blocks.shape
        cap = deflate_coder.encode_cap(n)
        lo, hi = DEFLATE_RECORD

        def make(lib):
            fn = ab_entry(lib, kernel)
            # since the tiled route, a build sizes its own scratch
            size = getattr(lib, "tpz_deflate_emit_scratch", None)
            if size is not None:
                size.argtypes, size.restype = [ctypes.c_int, ctypes.c_int], \
                    ctypes.c_longlong
            rows = b * deflate_coder.SCRATCH_BYTES
            nbytes = rows if size is None else size(b, n)

            def run():
                out = (torch.zeros((b, cap), dtype=torch.uint8,
                                   device="cuda"),
                       torch.empty(b, dtype=torch.int32, device="cuda"),
                       torch.empty(nbytes, dtype=torch.uint8, device="cuda"))
                head = ((blocks.data_ptr(), lens.data_ptr())
                        if kernel == "deflate_emit" else ())
                mid = (b, n, mode) if kernel == "deflate_emit" else (b, n)
                _build.check(fn(*head, tokens.data_ptr(), ntok.data_ptr(),
                                *mid, out[0].data_ptr(), cap,
                                out[1].data_ptr(), out[2].data_ptr(),
                                stream()), f"tpz_{kernel}")
                rec = out[2][:rows].view(b, deflate_coder.SCRATCH_BYTES)
                return out[0], out[1], rec[:, lo:hi]
            return run
        # the longest row's tokens
        steps = int(ntok.max())
    elif kernel == "lz4p_pack":
        comp, clens, n = args[:3]
        split = kw.get("split", args[3] if len(args) > 3 else True)
        b, w = comp.shape
        cap = lz4p_coder.encode_cap(n)

        def make(lib):
            fn = ab_entry(lib, kernel)

            def run():
                out = (torch.zeros((b, cap), dtype=torch.uint8,
                                   device="cuda"),
                       torch.empty(b, dtype=torch.int32, device="cuda"))
                _build.check(fn(comp.data_ptr(), clens.data_ptr(), b, w,
                                out[0].data_ptr(), cap, out[1].data_ptr(),
                                int(split), stream()), "tpz_lz4p_pack")
                return out
            return run
        # the longest stream's sequences
        r = int(clens.argmax())
        steps = int(lz4p_coder._lz4_sequences(comp[r : r + 1].cpu(),
                                              clens[r : r + 1].cpu())[4].sum())
    else:
        if not torch.is_tensor(args[2]):
            # bin_apm.decode_batch(comp, lengths, out_n, bits, rate, apm)
            streams, lens, out_n = args[:3]
            deltas, nc = None, -(-8 * out_n // bin_coder.CHUNK)
            nbits = (lens.to(torch.int64).clamp(0, out_n) * 8).to(torch.int32)
        else:
            streams, deltas, nbits = args[:3]
            nc = deltas.shape[1]
        knobs = tuple(int(k) for k in args[3:6])

        def make(lib):
            fn = ab_entry(lib, kernel)

            def run():
                out = torch.empty((streams.shape[0], nc * bin_coder.CHUNK // 8),
                                  dtype=torch.uint8, device="cuda")
                _build.check(fn(
                    streams.data_ptr(),
                    None if deltas is None else deltas.data_ptr(),
                    nbits.data_ptr(), streams.shape[0], streams.shape[1], nc,
                    out.data_ptr(), *knobs, stream()), "tpz_bin_decode")
                return (out,)
            return run
        steps = int(nbits.max())
    return {k: make(lib) for k, lib in libs.items()}, steps


# the keyed tables of the lz4 encoders as PR 13-22's wrappers sized them
# (a DIR's keyed routes, before the tiled and sorted links): 2^slots_log
# slots of KEY_SLOT bytes, twice the hashes a row can hold, one a row or a
# pool within KEYED_POOL_BYTES; lz4_dense.cu's direct tables of int32
# slots up to 12 bits
def old_lz4_table(bits: int, n: int, b: int, direct_max: int = -1):
    """(keyed, the table's log2 slots, tables, bytes a table) of a DIR's
    keyed (or, at bits <= direct_max, direct) links or candidates."""
    if bits <= direct_max:
        tbytes = max(16, 4 << bits)
        return False, bits, max(1, min(b, KEYED_POOL_BYTES // tbytes)), tbytes
    slog = max(6, min(bits + 1, (2 * max(n, 1) - 1).bit_length()))
    return (True, slog, max(1, min(b, KEYED_POOL_BYTES // (KEY_SLOT << slog))),
            KEY_SLOT << slog)


def ab_links_run(rows, lens, bits: int):
    """A closure of the checkout's links at `bits` past the shared route
    (csrc/lz4_links.cu, tiled or sorted by shape) -> prev."""
    from tpuzip_torch.kernels import lz4_links
    return lambda: lz4_links.lz4_links(rows, lens, bits)


def ab_chain_runs(lib, blocks, lens, hash_log: int, max_chain: int) -> dict:
    """{launch: a closure that runs it once} for one build of
    csrc/lz4_chain.cu on rows at (hash_log, max_chain): the links on the
    build's route (a DIR's keyed table or shared kernel, the checkout's
    shared kernel or csrc/lz4_links.cu's tiled or sorted links), best and
    the parse over the words; and "encode", the whole encode as the
    build's wrapper runs it -> (comp, clens)."""
    b, n = blocks.shape
    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    bits = lz4_coder.resolve_hash_log(hash_log)
    shared = n <= lz4_chain.STAGE_MAX and bits <= lz4_chain.SHARED_MAX_LOG
    keyed_lib = hasattr(lib, "tpz_lz4_chain_links")
    cap_n = lz4_coder.encode_cap(n)
    if keyed_lib and not shared:
        _, slog, ntab, tbytes = old_lz4_table(bits, n, b)
        tables = torch.empty(ntab * tbytes // 4, dtype=torch.int32,
                             device="cuda")

    def links():
        if not shared and not keyed_lib:
            return ab_links_run(blocks, lens, bits)()
        prev = torch.empty((b, n), dtype=torch.int32, device="cuda")
        if shared:
            fn = lib.tpz_lz4_chain_links_shared
            fn.argtypes = [vp, vp, ci, ci, vp, ci, vp]
            err = fn(blocks.data_ptr(), lens.data_ptr(), b, n,
                     prev.data_ptr(), bits, stream())
        else:
            fn = lib.tpz_lz4_chain_links
            fn.argtypes = [vp, vp, ci, ci, vp, vp, ci, ci, ci, vp]
            err = fn(blocks.data_ptr(), lens.data_ptr(), b, n,
                     prev.data_ptr(), tables.data_ptr(), ntab, bits, slog,
                     stream())
        _build.check(err, "tpz_lz4_chain_links")
        return prev

    def best(prev):
        words = torch.empty((b, n), dtype=torch.int32, device="cuda")
        fn = lib.tpz_lz4_chain_best
        fn.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp]
        _build.check(fn(blocks.data_ptr(), lens.data_ptr(), prev.data_ptr(),
                        b, n, max_chain, words.data_ptr(), stream()),
                     "tpz_lz4_chain_best")
        return words

    def parse(prev, words):
        comp = torch.zeros((b, cap_n), dtype=torch.uint8, device="cuda")
        clens = torch.empty(b, dtype=torch.int32, device="cuda")
        fn = lib.tpz_lz4_chain_parse
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, ci, vp, vp]
        _build.check(fn(blocks.data_ptr(), lens.data_ptr(), prev.data_ptr(),
                        words.data_ptr(), b, n, max_chain, comp.data_ptr(),
                        cap_n, clens.data_ptr(), stream()),
                     "tpz_lz4_chain_parse")
        return comp, clens

    prev = links()
    words = best(prev)

    def encode():
        p = links()
        return parse(p, best(p))

    return {"links": links, "best": lambda: best(prev),
            "parse": lambda: parse(prev, words), "encode": encode}


def ab_dense_runs(lib, rows, lens, hash_log: int) -> dict:
    """{launch: a closure} for one build of csrc/lz4_dense.cu at hash_log,
    on the route its wrapper takes there: the shared route's words and the
    parse over them; past it a DIR's candidates (direct or keyed tables)
    and their parse, or the checkout's links (csrc/lz4_links.cu, tiled or
    sorted), the words from them and the parse over the words; "encode"
    as the build's wrapper runs it -> (comp, clens)."""
    b, n = rows.shape
    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    bits = lz4_dense.table_bits(hash_log)
    shared = n <= lz4_dense.STAGE_MAX and bits <= lz4_dense.SHARED_MAX_LOG
    keyed_lib = hasattr(lib, "tpz_lz4_dense_candidates")
    cap_n = lz4_coder.encode_cap(n)

    def out():
        return (torch.zeros((b, cap_n), dtype=torch.uint8, device="cuda"),
                torch.empty(b, dtype=torch.int32, device="cuda"))

    def words_parse(words):
        comp, clens = out()
        fn = lib.tpz_lz4_dense_words_parse
        fn.argtypes = [vp, vp, vp, ci, ci, vp, ci, vp, vp]
        _build.check(fn(rows.data_ptr(), lens.data_ptr(), words.data_ptr(),
                        b, n, comp.data_ptr(), cap_n, clens.data_ptr(),
                        stream()), "tpz_lz4_dense_words_parse")
        return comp, clens

    if shared:
        def words_of():
            words = torch.empty((b, n), dtype=torch.int32, device="cuda")
            fn = lib.tpz_lz4_dense_words
            fn.argtypes = [vp, vp, ci, ci, ci, vp, vp]
            _build.check(fn(rows.data_ptr(), lens.data_ptr(), b, n, bits,
                            words.data_ptr(), stream()),
                         "tpz_lz4_dense_words")
            return words

        words = words_of()
        return {"words": words_of,
                "words_parse": functools.partial(words_parse, words),
                "encode": lambda: words_parse(words_of())}
    if keyed_lib:
        keyed, tlog, ntab, tbytes = old_lz4_table(bits, n, b, 12)
        tables = torch.empty(ntab * tbytes // 4, dtype=torch.int32,
                             device="cuda")

        def candidates():
            cand = torch.empty((b, n), dtype=torch.int32, device="cuda")
            fn = lib.tpz_lz4_dense_candidates
            fn.argtypes = [vp, vp, ci, ci, vp, vp, ci, ci, ci, ci, vp]
            _build.check(fn(rows.data_ptr(), lens.data_ptr(), b, n,
                            cand.data_ptr(), tables.data_ptr(), ntab, bits,
                            tlog, int(keyed), stream()),
                         "tpz_lz4_dense_candidates")
            return cand

        def parse(cand):
            comp, clens = out()
            fn = lib.tpz_lz4_dense_parse
            fn.argtypes = [vp, vp, vp, ci, ci, vp, ci, vp, vp]
            _build.check(fn(rows.data_ptr(), lens.data_ptr(),
                            cand.data_ptr(), b, n, comp.data_ptr(), cap_n,
                            clens.data_ptr(), stream()),
                         "tpz_lz4_dense_parse")
            return comp, clens

        cand = candidates()
        return {"candidates": candidates,
                "parse": functools.partial(parse, cand),
                "encode": lambda: parse(candidates())}
    links = ab_links_run(rows, lens, bits)

    def words_links(prev):
        words = torch.empty((b, n), dtype=torch.int32, device="cuda")
        fn = lib.tpz_lz4_dense_words_links
        fn.argtypes = [vp, vp, vp, ci, ci, vp, vp]
        _build.check(fn(rows.data_ptr(), lens.data_ptr(), prev.data_ptr(), b,
                        n, words.data_ptr(), stream()),
                     "tpz_lz4_dense_words_links")
        return words

    prev = links()
    words = words_links(prev)
    return {"links": links, "words_links": functools.partial(words_links,
                                                             prev),
            "words_parse": functools.partial(words_parse, words),
            "encode": lambda: words_parse(words_links(links()))}


def top_bits_rows(b: int, n: int, seed: int) -> np.ndarray:
    """(b, n) u8 rows whose every 4-byte-aligned 4-gram hashes to h with
    the same top 16 bits at 24 and at 32 bits (seq = (T << 16 | k) times
    the inverse of the hash's multiplier, k random): the rows on which a
    sort by the top bits of h first would put a quarter of a row's
    positions in one bucket."""
    rng = np.random.default_rng(seed)
    inv = pow(lz4_coder.HASH_MUL, -1, 1 << 32)
    k = rng.integers(0, 1 << 16, (b, n // 4), dtype=np.uint64)
    seq = (((0x5A5A << 16) | k) * np.uint64(inv)) & np.uint64(0xFFFFFFFF)
    return seq.astype("<u4").view(np.uint8).reshape(b, n)


def ab_lz4(src: str, libs: dict) -> dict:
    """{shape: row}: each build's encode of `src` (csrc/lz4_chain.cu or
    csrc/lz4_dense.cu) at its paths' shapes, outputs checked equal, timed
    in turns (old, new, new, old; each the mean of 3 launches), and each
    launch of each build timed alone.  lz4_chain: the lz4_chain path's
    1024 x 64 KiB rows at hash_log 16 and max_chain 2, 8 and 64, 1024 zero
    rows at 8 and 64, 1024 random rows at 8, the path's rows at hash_log
    24 (max_chain 8), and the wide path's 64 x 128 KiB at 16.  lz4_dense:
    the serving path's tensor at compress_from_device's 15 bits and at 20,
    24 and 32 (device_encode's route past 16 bits), as many zero, b"ab"
    and random rows at 20, as many top_bits_rows at 32, and the wide
    path's 64 x 128 KiB at 16."""
    x, lens, _ = serving_tensor()
    rng = np.random.default_rng(SEED + 16)
    kinds = {"text": x, "zero": torch.zeros_like(x),
             "ab": torch.tensor([97, 98], dtype=torch.uint8,
                                device="cuda").repeat(x.numel() // 2).view(
                                    x.shape),
             "random": torch.from_numpy(rng.integers(
                 0, 256, tuple(x.shape), np.uint8)).cuda()}
    wide = x.view(-1)[:LZ4_WIDE_BYTES].view(-1, LZ4_WIDE_BLOCK)
    wide_lens = torch.full((wide.shape[0],), LZ4_WIDE_BLOCK,
                           dtype=torch.int32, device="cuda")
    if src == "lz4_chain":
        shapes = {f"text_max_chain_{mc}": (x, lens, 16, mc)
                  for mc in (2, 8, 64)}
        shapes.update(zero_max_chain_8=(kinds["zero"], lens, 16, 8),
                      zero_max_chain_64=(kinds["zero"], lens, 16, 64),
                      random_max_chain_8=(kinds["random"], lens, 16, 8),
                      text_hash_log_24=(x, lens, 24, 8),
                      wide_hash_log_16=(wide, wide_lens, 16, 8))
        make = {k: (lambda lib, a=a: ab_chain_runs(lib, *a))
                for k, a in shapes.items()}
    else:
        shapes = {"text_hash_log_15": (x, lens, lz4_dense.HASH_LOG)}
        shapes.update({f"text_hash_log_{hl}": (x, lens, hl)
                       for hl in (20, 24, 32)})
        shapes.update({f"{k}_hash_log_20": (kinds[k], lens, 20)
                       for k in ("zero", "ab", "random")})
        shapes["top_bits_hash_log_32"] = (torch.from_numpy(top_bits_rows(
            *x.shape, SEED + 17)).cuda(), lens, 32)
        shapes["wide_hash_log_16"] = (wide, wide_lens, 16)
        make = {k: (lambda lib, a=a: ab_dense_runs(lib, *a))
                for k, a in shapes.items()}
    res = {}
    for shape, mk in make.items():
        runs = {k: mk(lib) for k, lib in libs.items()}
        ref = runs["new"]["encode"]()
        row = {"outputs_equal": {
            k: all(torch.equal(a, c) for a, c in zip(r["encode"](), ref))
            for k, r in runs.items()}}
        for k in runs:
            if k == "new":
                continue
            t = [cuda_ms(runs[j]["encode"], 3) for j in (k, "new", "new", k)]
            old_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            row[k] = {"old_ms": old_ms, "new_ms": new_ms,
                      "new_over_old": new_ms / old_ms, "turns_ms": t}
        row["launch_ms"] = {k: {name: cuda_ms(fn, 3) for name, fn in r.items()
                                if name != "encode"}
                            for k, r in runs.items()}
        if src == "lz4_chain":   # the links alone in turns
            t = {k: [] for k in runs}
            for k in runs:
                if k != "new":
                    for j in (k, "new", "new", k):
                        t[j].append(cuda_ms(runs[j]["links"], 3))
            row["links_turns_ms"] = t
        del runs
        res[shape] = row
    return res


def ab_child(dirs: list) -> int:
    """python3 chip_smoke.py --ab DIR [DIR ...]: the checkout's
    csrc/ari_encode.cu, ari_decode.cu, bin_decode.cu, mtf.cu, bin_encode.cu,
    dc_decode.cu, lz4_encode.cu, lz4_decode.cu, rle.cu, inflate.cu,
    lz4p.cu, deflate_encode.cu's links (both routes), its greedy parse and
    its tables and emit in both orders,
    lz4_chain.cu and lz4_dense.cu
    against the same files in each
    DIR (beside the headers they include), for instance a parent commit's:

        mkdir -p _parent && for f in $(git ls-tree --name-only REV \\
            tpuzip_torch/csrc/); do git show REV:$f > _parent/${f##*/}; done

    Builds them all at once (those of the checkout whose source some DIR
    holds) with their registers and spills, takes each
    kernel's launch on the container paths (ari_encode and ari_decode at
    the ari, bwt, bwt_big and bwtdc paths; mtf both ways at the bwt and
    bwt_big paths; bin_encode and bin_decode at the bin and apm paths, and
    bin_decode at apm without the chunk index; dc_decode at the bwtdc
    path; the lz4 and rle kernels at their paths; inflate at the deflate
    path and on phase 3's edge and garbage streams; lz4p's pack at the
    lz4p and lz4p serving paths and on phase 3's pack edge rows, its
    decode at the lz4p path; deflate_encode.cu's links at the deflate
    path and on as many zero, b"ab" and random rows (the shared route),
    its links past 64 KiB (a DIR's keyed route against the checkout's
    tiled one) at the wide path, on as many zero rows and on phase 18's
    8 MiB row, its greedy parse (with the best kernel) on the serving
    tensor, as many zero and random rows and that 8 MiB row, its tables
    and emit (tpz_deflate_emit,
    streams, lengths and the record in the scratch) at the deflate and
    wide paths, on those rows' tokens and on phase 3's table rows, and the
    device rule's (tpz_deflate_emit_tuple) at the serving path, on as many
    zero and random rows, on that 8 MiB row and on the table rows; a
    kernel whose source no DIR holds gets a
    line that says so and no row, and the paths of no other kernel are
    not run), checks that every build gives the same outputs there
    (streams, lengths and chunk index; symbols; bits; run triples and
    err; bytes and statuses), and times each DIR's kernel and the
    checkout's in turns (old, new, new, old; each the mean of 3
    launches), with ns a step (the longest row's symbols, bits, walked
    runs, stream bytes of an rle decode, sequences of an lz4 or lz4p
    decode or a pack, or the longest stream's symbols of an inflate).  A
    DIR that holds ari_decode_dot.cu (tpuzip's v1 decoder on frequency
    state, since removed) gives one more row, ari_decode_dot: that kernel
    against the checkout's dot route (ari_decode.cu) at the ari path's
    decode launch and on phase 5's A/B mix.  Beside them: ari_decode's
    no-index mode at the ari shape; one row alone against all the rows at
    the bwt, bwtdc, bin, apm, lz4, rle, deflate (the links, and the
    tables with the emit) and lz4p shapes, for every build; the chained and dense lz4 encoders at their paths' shapes
    (ab_lz4); and whether the SASS of each kernel of
    AB_KERNELS that this checkout does not redesign (all but
    AB_REDESIGNED), and of each source of AB_SASS_ONLY and AB_LZ4_SOURCES,
    equals the DIR's build of it: the functions that carry the kernel's
    name, or the AB_FUNCTIONS it names (all of the source where none
    does, as in mtf.cu, less the functions of the A/B kernels timed from
    it, as deflate_encode.cu's links, tables and emit), so that
    rle_decode is held apart from rle_encode in rle.cu;
    and, to be read, whether each of a redesigned kernel's old functions
    is still among the checkout's (sass_kept_in_redesigned).  One JSON line a kernel and shape,
    then one line of the whole; exits 1 if any outputs differed."""
    if not dirs:
        raise SystemExit("chip_smoke.py --ab needs a directory")
    smi = nvidia_smi()
    nvcc = _build.find_nvcc()
    jobs = {}
    for kernel in (AB_KERNELS + AB_SASS_ONLY + AB_LZ4_SOURCES
                   + ("ari_decode_dot",)):
        src = AB_SOURCE.get(kernel, kernel)
        held = [i for i, d in enumerate(dirs)
                if os.path.exists(f"{d}/{src}.cu")]
        # the checkout's build of a source no DIR holds is not needed
        if kernel != "ari_decode_dot" and held:
            jobs[f"new:{kernel}"] = _build.CSRC / f"{src}.cu"
        for i in held:
            jobs[f"old{i}:{kernel}"] = f"{dirs[i]}/{src}.cu"
    res = {"nvidia_smi": smi, "old": {f"old{i}": d for i, d in
                                      enumerate(dirs)}}
    differ = []
    with tempfile.TemporaryDirectory() as tmp:
        so = {name: f"{tmp}/{name.replace(':', '_')}.so" for name in jobs}
        procs = {name: subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so[name],
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for name, src in jobs.items()}
        try:
            res["ptxas"] = ptxas_report(procs)
        finally:
            for proc in procs.values():
                proc.kill()
                proc.wait()
        # the kernel's own functions' SASS (all of a source whose
        # functions do not carry the kernel's name, as mtf.cu's), whatever
        # the unnamed namespace's mangled name (it hashes the source's path)
        def sass(name):
            funcs = sass_functions(nvcc, so[name])
            kernel = name.split(":")[1]
            own = AB_FUNCTIONS.get(kernel, (f"{kernel}_kernel",))
            # a source whose functions do not carry its name: all of them
            # but those of the A/B kernels timed from it (deflate_encode.cu's
            # links, both routes, and its tables and emit)
            timed = [part for k, src in AB_SOURCE.items() if src == kernel
                     for part in AB_FUNCTIONS.get(k, (k,))]
            return sorted(v for f, v in funcs.items()
                          if any(o in f for o in own)) or sorted(
                v for f, v in funcs.items() if not any(k in f for k in timed))

        # each of the DIR's functions found in the checkout's build (a
        # kernel the checkout turned into a template, as rle_encode_kernel,
        # holds the DIR's among its instances)
        def kept(old, new):
            new = list(new)
            for f in old:
                if f not in new:
                    return False
                new.remove(f)
            return True

        res["sass_unchanged"] = {
            name: kept(sass(name), sass("new:" + name.split(":")[1]))
            for name in jobs if not name.startswith("new")
            and name.split(":")[1] in (AB_KERNELS + AB_SASS_ONLY
                                       + AB_LZ4_SOURCES)
            and name.split(":")[1] not in AB_REDESIGNED}
        # and, to be read and not required, whether each of the DIR's
        # functions of a redesigned kernel is still among the checkout's
        # (the keyed links beside the new shared ones)
        res["sass_kept_in_redesigned"] = {
            name: kept(sass(name), sass("new:" + name.split(":")[1]))
            for name in jobs if not name.startswith("new")
            and name.split(":")[1] in AB_REDESIGNED}
        libs = {}
        for name in jobs:
            build, kernel = name.split(":")
            libs.setdefault(kernel, {})[build] = ctypes.CDLL(so[name])
        if "ari_decode_dot" in libs:
            libs["ari_decode_dot"]["new"] = libs["ari_decode"]["new"]
        shapes = {}
        # a kernel no DIR holds (a source newer than every DIR) has no row
        res["skipped"] = sorted(k for k in AB_KERNELS
                                if set(libs.get(k, {})) <= {"new"})
        for kernel in res["skipped"]:
            print(json.dumps({"kernel": kernel, "skipped": "no DIR holds "
                              f"{AB_SOURCE.get(kernel, kernel)}.cu"}),
                  flush=True)
        inputs = ab_inputs(set(AB_KERNELS) - set(res["skipped"]))
        for kernel, paths in inputs.items():
            if kernel not in libs or kernel in res["skipped"]:
                continue
            for path, (args, kw) in paths.items():
                runs, steps = ab_launchers(libs[kernel], kernel, args, kw)
                ref = runs["new"]()
                equal = {k: all(torch.equal(x, y) for x, y in
                                zip(run(), ref)) for k, run in runs.items()}
                if not all(equal.values()):
                    differ.append(f"{kernel} at {path}: {equal}")
                row = {"rows": list(args[0].shape), "steps": steps,
                       "outputs_equal": equal}
                for k in runs:
                    if k == "new":
                        continue
                    t = [cuda_ms(runs[j], 3) for j in (k, "new", "new", k)]
                    old_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                    row[k] = {"old_ms": old_ms, "new_ms": new_ms,
                              "new_over_old": new_ms / old_ms, "turns_ms": t,
                              "ns_a_step": [old_ms * 1e6 / max(steps, 1),
                                            new_ms * 1e6 / max(steps, 1)]}
                if kernel == "ari_decode" and path == "ari":
                    # the no-index mode on the same stream rows (a row's
                    # stream bytes do not depend on the index beside it)
                    flat, _ = ab_launchers(
                        {"new": libs[kernel]["new"]}, kernel,
                        (args[0], None, *args[2:]), {"nc": args[1].shape[1]})
                    if not torch.equal(flat["new"]()[0], ref[0]):
                        differ.append("ari_decode's no-index mode")
                    row["unindexed_ms"] = cuda_ms(flat["new"], 3)
                if (path in ("bwt", "bin", "apm", "lz4", "rle", "deflate",
                             "lz4p", "serving") or kernel == "dc_decode"):
                    one, _ = ab_launchers(
                        libs[kernel], kernel,
                        tuple(a[:1].contiguous() if torch.is_tensor(a)
                              else a for a in args), kw)
                    row["one_row_ms"] = {k: cuda_ms(run, 3)
                                         for k, run in one.items()}
                    row["all_rows_ms"] = {k: cuda_ms(run, 3)
                                          for k, run in runs.items()}
                shapes.setdefault(kernel, {})[path] = row
                print(json.dumps({"kernel": kernel, "path": path, **row}),
                      flush=True)
        for src in AB_LZ4_SOURCES:
            if set(libs.get(src, {})) <= {"new"}:
                print(json.dumps({"kernel": src, "skipped":
                                  f"no DIR holds {src}.cu"}), flush=True)
                continue
            for shape, row in ab_lz4(src, libs[src]).items():
                if not all(row["outputs_equal"].values()):
                    differ.append(f"{src} at {shape}: {row['outputs_equal']}")
                shapes.setdefault(src, {})[shape] = row
                print(json.dumps({"kernel": src, "path": shape, **row}),
                      flush=True)
    res["shapes"] = shapes
    res["outputs_differ"] = differ
    print(json.dumps(res))
    return 1 if differ else 0


def launched(counts: dict, name: str) -> int:
    """A path's launches of kernel `name`, in either mode."""
    return counts.get(name, 0) + counts.get(f"{name}_unindexed", 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--trace"]:
        return trace_child(sys.argv[2])
    if sys.argv[1:2] == ["--ab"]:
        return ab_child(sys.argv[2:])
    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    phase_build()
    small = phase_kernels()
    ari_launches, ari_kernels, decode_call, ari_blob = phase_main(smi)
    dot_launches, dot_kernel = phase_dot(smi, decode_call)
    del decode_call
    bwt_launches, bwt_kernels = phase_bwt(smi)
    big_launches, big_kernels = phase_bwt_big(smi)
    dc_launches, dc_kernels, dc_peak = phase_bwtdc(smi)
    bin_launches, bin_kernels, apm_blob = phase_bin(smi)
    legacy_launches, legacy_kernels = phase_legacy(
        smi, {"ari": ari_blob, "apm": apm_blob})
    del ari_blob, apm_blob
    lz4_launches, lz4_kernels, lz4_payload = phase_lz(smi, "lz4")
    rle_launches, rle_kernels, _ = phase_lz(smi, "rle")
    serve_launches, serve_kernels, encode_launches = phase_serving(smi)
    # the shared route at 16 bits, the sorted links at 20
    corpus_launches = phase_corpus(smi, lz4_payload, dc_peak)
    chain_launches, wide_launches, chain_kernels = phase_lz4_chain(
        smi, lz4_payload)
    (lz4p_launches, lz4p_serve_launches, lz4p_kernels,
     lz4p_serve_kernels) = phase_lz4p(smi)
    (deflate_launches, deflate_dev_launches, deflate_wide_launches,
     deflate_kernels) = phase_deflate(smi)
    zlib_launches, zlib_errs = phase_zlib(smi)
    streams_launches, streams_kernels = phase_streams(smi)
    if "jax" in sys.modules or any(m.split(".")[0] == "tpuzip"
                                   for m in sys.modules):
        raise AssertionError("the port's path imported jax or tpuzip")
    by_path = {"ari": ari_launches, "bwt": bwt_launches,
               "bwt_big": big_launches, "bwtdc": dc_launches,
               "bin": bin_launches["bin"], "apm": bin_launches["apm"],
               "dot": dot_launches, "legacy": legacy_launches,
               "lz4": lz4_launches, "rle": rle_launches,
               "serving": serve_launches,
               "device_encode": encode_launches[16],
               "device_encode_20": encode_launches[20],
               "corpus": corpus_launches, "lz4_chain": chain_launches,
               **wide_launches,
               "lz4p": lz4p_launches, "lz4p_serving": lz4p_serve_launches,
               "deflate": deflate_launches,
               "deflate_to_device": deflate_dev_launches,
               "deflate_wide": deflate_wide_launches,
               "zlib": zlib_launches, "streams": streams_launches}
    # times at the main paths' shapes: ari at 1024 x 64 KiB, MTF at the bwt
    # path's 64 x 1 MiB, the DC walk at the bwtdc path's, the bin kernels
    # at the apm path's 1024 x 64 KiB (bin beside it), the dot decoder at
    # the ari path's decode inputs, lz4 and rle at theirs (1024 x 64 KiB),
    # the dense lz4 words and rle segment kernels at the serving path's, the
    # sorted links and the words from them at device_encode's at hash_log
    # 20, the chained lz4 kernels at the lz4_chain path's, the tiled lz4
    # links at the wide lz4 path's 128 KiB rows, lz4p's at its compress
    # path's, deflate's at its path's (the tiled links at the wide path's
    # 128 KiB rows); the error over every phase
    dot_kernels = {"ari_decode_dot": dot_kernel}
    at_shape = {**bwt_kernels, **ari_kernels,
                "dc_decode": dc_kernels["dc_decode"], **bin_kernels,
                **dot_kernels, **lz4_kernels, **rle_kernels, **serve_kernels,
                **chain_kernels, **lz4p_kernels, **deflate_kernels,
                **streams_kernels}
    checked = ({k: {"max_abs_err": e} for k, e in small.items()},
               ari_kernels, bwt_kernels, big_kernels, dc_kernels, bin_kernels,
               dot_kernels, legacy_kernels, lz4_kernels, rle_kernels,
               serve_kernels, chain_kernels, lz4p_kernels,
               {"lz4_dense_words_links":
                chain_kernels["lz4_dense_words_links_wide"]},
               lz4p_serve_kernels, deflate_kernels,
               {k: {"max_abs_err": e} for k, e in zlib_errs.items()},
               streams_kernels)
    # each emit wrapper's kernels by route, as its traces show them
    for name, seen in EMIT_TRACED.items():
        if sorted(seen) != ["row", "tiled"]:
            raise AssertionError(f"{name}: traced on the routes "
                                 f"{sorted(seen)}, not on both")
    print(smi)
    rows = []
    for name, source, replaces in (
            ("ari_encode", "ari_encode.cu",
             "tpuzip/kernels/range_coder.py:128"),
            ("ari_decode", "ari_decode.cu",
             "tpuzip/kernels/range_decoder.py:469"),
            ("mtf_encode", "mtf.cu", "tpuzip/kernels/mtf_scan.py:33"),
            ("mtf_decode", "mtf.cu", "tpuzip/kernels/mtf_scan.py:33"),
            ("dc_decode", "dc_decode.cu", "tpuzip/kernels/dc_scan.py:37"),
            ("bin_encode", "bin_encode.cu",
             "tpuzip/kernels/bin_coder.py:38"),
            ("bin_decode", "bin_decode.cu",
             "tpuzip/kernels/bin_coder.py:341"),
            ("ari_decode_dot", "ari_decode.cu",
             "tpuzip/kernels/range_decoder.py:559"),
            # no Pallas kernel: these replace tpuzip's host C++ coder
            ("lz4_encode", "lz4_encode.cu",
             "csrc/tpuzip_host.cpp:190 tpz_lz4_compress"),
            ("lz4_decode", "lz4_decode.cu",
             "csrc/tpuzip_host.cpp:252 tpz_lz4_decompress"),
            ("rle_encode", "rle.cu",
             "csrc/tpuzip_host.cpp:1795 tpz_rle_encode"),
            ("rle_decode", "rle.cu",
             "csrc/tpuzip_host.cpp:1822 tpz_rle_decode"),
            # tpuzip's device encoders (XLA, not Pallas), which its
            # compress_from_device runs
            ("lz4_dense_words", "lz4_dense.cu",
             "tpuzip/codecs/lz4.py:153 _candidates"),
            ("lz4_dense_words_links", "lz4_dense.cu",
             "tpuzip/codecs/lz4.py:153 _candidates (its filter)"),
            ("lz4_dense_words_parse", "lz4_dense.cu",
             "tpuzip/codecs/lz4.py:179 encode"),
            ("rle_encode_seg", "rle.cu", "tpuzip/codecs/rle.py:30 encode"),
            # tpuzip's chained lz4 encoder (host C++) and its lz4p coder
            # (host C++ and XLA)
            ("lz4_chain_links", "lz4_chain.cu",
             "csrc/tpuzip_host.cpp:463 tpz_lz4_compress_chained (its "
             "hash chain)"),
            ("lz4_chain_best", "lz4_chain.cu",
             "csrc/tpuzip_host.cpp:463 tpz_lz4_compress_chained (its "
             "find_best)"),
            ("lz4_chain_parse", "lz4_chain.cu",
             "csrc/tpuzip_host.cpp:463 tpz_lz4_compress_chained"),
            # both lz4 encoders' links past their shared routes
            ("lz4_links_tiled", "lz4_links.cu",
             "csrc/tpuzip_host.cpp:463 tpz_lz4_compress_chained (its "
             "hash chain); tpuzip/codecs/lz4.py:153 _candidates"),
            ("lz4_links_sorted", "lz4_links.cu",
             "tpuzip/codecs/lz4.py:153 _candidates (its argsort); "
             "csrc/tpuzip_host.cpp:463 tpz_lz4_compress_chained (its "
             "hash chain)"),
            ("lz4p_pack", "lz4p.cu",
             "csrc/tpuzip_host.cpp:333 tpz_lz4p_encode; "
             "tpuzip/codecs/lz4p.py:50 encode"),
            ("lz4p_decode", "lz4p.cu",
             "csrc/tpuzip_host.cpp:409 tpz_lz4p_decode; "
             "tpuzip/codecs/lz4p.py:156 decode"),
            # tpuzip's deflate coder (host C++)
            ("deflate_links", "deflate_encode.cu",
             "csrc/tpuzip_host.cpp:1338 tpz_deflate (its hash chain)"),
            ("deflate_links_shared", "deflate_encode.cu",
             "csrc/tpuzip_host.cpp:1338 tpz_deflate (its hash chain)"),
            ("deflate_parse", "deflate_encode.cu",
             "csrc/tpuzip_host.cpp:1356 tpz_deflate (its lazy parse)"),
            ("deflate_emit", "deflate_encode.cu",
             "csrc/tpuzip_host.cpp:1409 tpz_deflate (tables and bits)"),
            ("inflate", "inflate.cu",
             "csrc/tpuzip_host.cpp:1020 tpz_inflate"),
            # tpuzip's device deflate rule (XLA and host Python), which its
            # compress_from_device, deflate() and zlib wrapper run
            ("deflate_parse_greedy", "deflate_encode.cu",
             "tpuzip/codecs/deflate.py:250 lz77_stage (greedy parse)"),
            ("deflate_emit_tuple", "deflate_encode.cu",
             "tpuzip/oracle/deflate.py:273 package_merge (tuple order) "
             "with tpuzip/codecs/deflate.py:396 _header_fields"),
            # the LZ4 frame and the streaming adapters (host C++ and
            # Python in tpuzip)
            ("xxh32_batch", "xxh32.cu",
             "csrc/tpuzip_host.cpp:92 tpz_xxh32; "
             "tpuzip/oracle/xxh32.py:23 xxh32"),
            ("xxh32_stripes", "xxh32.cu",
             "csrc/tpuzip_host.cpp:74 tpz_xxh32_stripes; "
             "tpuzip/oracle/xxh32.py:56 Xxh32State"),
            ("lz4_decode_history", "lz4_decode.cu",
             "tpuzip/oracle/lz4.py:265 _decompress_linked"),
            ("deflate_emit_fragment", "deflate_encode.cu",
             "csrc/tpuzip_host.cpp:1592 tpz_deflate_fragment"),
            ("inflate_ends", "inflate.cu",
             "tpuzip/oracle/deflate.py:186 decompress_ex (its bytes "
             "consumed)")):
        k = at_shape[name]
        extra = {key: k[key] for key in ("ms_bin", "bound_ms_bin") if key in k}
        if name in EMIT_TRACED:
            extra["device_kernels"] = {
                route: sorted(names)
                for route, names in sorted(EMIT_TRACED[name].items())}
        rows.append({
            "name": name, "route": "cuda",
            "source": f"tpuzip_torch/csrc/{source}", "replaces": replaces,
            # the decoders' launches without the chunk index count too
            "launches": sum(launched(c, name) for c in by_path.values()),
            "launches_by_path": {p: launched(c, name)
                                 for p, c in by_path.items()},
            "max_abs_err": max(c[key]["max_abs_err"] for c in checked
                               for key in (name, f"{name}_unindexed")
                               if key in c),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "shape": k["inputs"],
            "plain_shape": k.get("plain_inputs", k["inputs"]), **extra})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
