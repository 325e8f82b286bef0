#!/usr/bin/env python3
"""Cycles a step, by part, of the ari encoder's, the apm bit decoder's, the
apm bit encoder's, the DC walk's and the lz4 encoder's steps as they stood
before their redesign, of the redesigned ari encoder by warp and of the
redesigned DC walk by part (tools/step_clocks.cu), on one real stream each,
on one GPU:

    python3 tools/step_clocks.py [SECTION ...]   # from a checkout's root

The encoder's stream is block 0 of the bwt path (the smoke's corpus at
1 MiB blocks, the ari encoder's input after BWT and MTF), and for the
redesign also block 0 of the bwtdc path (after BWT and DC); the decoder's
is block 0 of the apm path at 64 KiB, and the bit encoder's that block's
bytes; the DC walk's is block 0 of the bwtdc path on the smoke's 64 MiB
corpus (the walk's own vals, first and length), a step there being one
walked run.  Each copy's output must equal the real kernel's on that
stream.  Reports for each the steps, the cycles a step of
each part (stamped run), of the stamped loop and of the unstamped loop,
and the unstamped copy's CUDA-event ms (cycles over ms is the SM clock
under this load); for the DC walk also the walked runs of all 64 streams
and csrc/dc_decode.cu's ms on row 0 alone and on all 64.  The lz4
encoder's rows are the lz4 path's (the 64 MiB corpus through
tpuzip_torch.compress with no codec, 1024 rows of 64 KiB), its step one
probe of one position, stamped on row 0 alone and beside the other 1023
rows, with csrc/lz4_encode.cu's ms on the same rows; the redesigned step
(32 positions a probe) likewise, its table in shared or device memory.
The lz4 and rle decoders' earlier steps (a sequence, a stream byte) are
stamped by part on their paths' rows (the corpus through compress with no
codec and with codec "rle"), row 0 alone and beside the other 1023 rows,
each copy held against the real decoder's bytes and statuses.  The
chained lz4 parse's window step as it stood before its redesign (a lane a
position, each walking its chain from device memory) is stamped by part
on the lz4_chain path's rows (max_chain 8 and 64), counting the positions
the parse never reads; the dense lz4 candidates step as it stood before
its redesign (keyed tables in device memory, and the direct ones of 15
bits it had before them) on the serving path's tensor; both on row 0
alone and beside the other 1023 rows, held against the kernels' output
(the dense candidates against their plain version: the kernel is gone).
The deflate decoder's step as it stood before its redesign (lane 0
decoding a symbol at a time) is stamped by part on the deflate path's
streams, and lz4p's pack as it stood before its redesign (two walks, a
sequence at a time) on the lz4p path's LZ4 streams, row 0 alone and
beside the other 1023 rows, each held against the real kernel's output;
likewise lz4p's decode as it stood before its redesign (a sequence at a
time after a pass of prefix sums) on the lz4p path's rows, the deflate
links as they stood before theirs (a warp a row, a keyed table in device
memory) on the deflate path's rows and on phase 18's one 8 MiB row
(beside the checkout's links there, the tiled route), the deflate tables
as they stood before theirs (lane 0's package-merge) on that path's
tokens, each copy's records and streams held against
csrc/deflate_encode.cu's, the device rule's greedy parse as it stood
before its redesign (a warp a row over windows of best values) on the
serving tensor's rows and that 8 MiB row, beside the checkout's parse in
segments on the same best values, and the device rule's tuple-order
tables as they stood before theirs (pools in shared memory, their own
histograms) on the serving path's tokens and that row.
One JSON line a section (SECTIONS; all of them without arguments, about
60-90 s; lz4_chain and lz4_dense alone about 30 s, inflate and lz4p_pack
about 30 s)."""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import tpuzip_torch  # noqa: E402
from tpuzip_torch.kernels import (_build, bin_coder, dc_scan,  # noqa: E402
                                  deflate_coder, lz4_chain, lz4_coder,
                                  lz4_dense, lz4p_coder, range_coder,
                                  rle_coder)

ARI_PARTS = ("symbol", "table reads", "division", "multiplies",
             "renormalisation", "update", "chunk test and loop")
WARP_PARTS = ("model warp busy", "model warp waits", "coder warp busy",
              "coder warp waits", "", "", "")
FINE_PARTS = ("model warp busy", "model warp waits", "coder step rest",
              "coder warp waits", "quotient", "products and correction",
              "renormalisation")
APM_ENC_PARTS = ("input byte", "split with the gate", "coder products",
                 "renormalisation and stores", "model update",
                 "chunk test and loop", "")
APM_PARTS = ("byte loads", "split", "division", "bit and coder update",
             "renormalisation", "model update", "bit packing and loop")
DC_PARTS = ("compares and the lane minimum", "vote", "min reduction",
            "target and bad", "add reduction", "update",
            "output select with the 32-step load and store", "loop test")
DC_KEYED_PARTS = ("shuffles, key and the test for the exact step",
                  "min reduction", "limit test and the entry put back",
                  "merge", "head kept", "group load and vote",
                  "triples, err and store", "exact redo")


def per_step(cycles, parts, steps: int) -> dict:
    """cycles[i] / steps for each named part, their sum, and the loop's
    (the entry after the parts)."""
    return {**{p: cycles[i] / steps for i, p in enumerate(parts) if p},
            "sum of parts": sum(cycles[:len(parts)]) / steps,
            "loop": cycles[len(parts)] / steps}


def dc_walk(lib, res) -> None:
    """The DC walk's copies on row 0 of the bwtdc path, held against
    csrc/dc_decode.cu's outputs there, into res["dc_walk"]."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    blob = tpuzip_torch.compress(data, codec="bwtdc", block_size=cs.BWT_BLOCK)
    with cs.recorded(dc_scan, "dc_decode_lanes") as calls:
        tpuzip_torch.decompress(blob)
    (args, _, out), = calls
    vals, first, lengths = args
    walked = (out[1] > 0).sum(1)
    runs, t = int(walked[0]), vals.shape[1]
    fn = lib.tpz_dc_walk_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp, vp, ci]
    row = (vals[0].contiguous(), first[0].contiguous())

    def run(which: int):
        got = torch.zeros((3, t), dtype=torch.int32, device="cuda")
        err = torch.zeros(1, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(9, dtype=torch.int64, device="cuda")
        _build.check(fn(row[0].data_ptr(), row[1].data_ptr(),
                        int(lengths[0]), t, got[0].data_ptr(),
                        got[1].data_ptr(), got[2].data_ptr(), err.data_ptr(),
                        cyc.data_ptr(), which), "dc_walk_clocks")
        torch.cuda.synchronize()
        return got, err, cyc.tolist()

    rec = res.setdefault("dc_walk", {
        "steps": t, "walked_runs_row0": runs,
        "walked_runs_all": walked.tolist()})
    for which, name, parts in ((3, "earlier_stamped", DC_PARTS),
                               (2, "earlier_unstamped", DC_PARTS),
                               (1, "redesign_stamped", DC_KEYED_PARTS),
                               (0, "redesign_unstamped", DC_KEYED_PARTS)):
        got, err, cyc = run(which)
        if not (all(torch.equal(got[i], out[i][0]) for i in range(3))
                and int(err) == int(out[3][0])):
            raise AssertionError(f"DC walk copy {name} differs from "
                                 "csrc/dc_decode.cu on row 0")
        rec[name] = per_step(cyc, parts, runs)
        if which in (2, 0):
            rec[f"{name}_ms"] = cs.cuda_ms(lambda: run(which), 3)
    rec["kernel_row0_ms"] = cs.cuda_ms(
        lambda: dc_scan.dc_decode_lanes(*(a[:1].contiguous() for a in args)),
        3)
    rec["kernel_all_ms"] = cs.cuda_ms(lambda: dc_scan.dc_decode_lanes(*args),
                                      3)


LZ4_PROBE_PARTS = ("4 bytes and hash", "table read",
                   "table write (not awaited)", "candidate read and compare")
LZ4_MATCH_PARTS = {4: "match extension", 5: "sequence writes"}
LZ4_STEP_PARTS = ("4 bytes and hash", "match_any", "table read",
                  "candidate read, compare and ballots",
                  "table write and syncwarp")
LZ4_STEP_MATCH_PARTS = {5: "match extension", 6: "sequence writes"}


def lz4_probe(lib, res) -> None:
    """The earlier lz4 encoder's copy on the lz4 path's rows (tpuzip_torch.
    compress with no codec on the smoke's 64 MiB corpus: 1024 rows of
    64 KiB), stamped on row 0 alone and beside the other 1023 rows, held
    against csrc/lz4_encode.cu's output there, into res["lz4_encode"]; and
    the redesigned step's copy by part, its table in shared or in device
    memory, its first window 32 or 8 wide (csrc/lz4_encode.cu's
    FIRST_WIDTH), on row 0 alone and beside the others."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    with cs.recorded(lz4_coder, "lz4_encode_batch") as calls:
        tpuzip_torch.compress(data)
    (args, _, out), = calls
    blocks, lens, hl = args[0], args[1], lz4_coder.resolve_hash_log(args[2])
    b_all, n = blocks.shape
    cap = out[0].shape[1]
    fn = lib.tpz_lz4_encode_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, ci, vp, ci]
    tables = torch.empty(b_all << hl, dtype=torch.int32, device="cuda")

    def launch(b: int, stamped: int):
        comp = torch.zeros((b, cap), dtype=torch.uint8, device="cuda")
        clens = torch.empty(b, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(10, dtype=torch.int64, device="cuda")
        _build.check(fn(blocks.data_ptr(), lens.data_ptr(), b, n,
                        comp.data_ptr(), cap, clens.data_ptr(),
                        tables.data_ptr(), hl, cyc.data_ptr(), stamped),
                     "lz4_encode_clocks")
        return comp, clens, cyc

    rec = res.setdefault("lz4_encode", {"hash_log": hl, "row_bytes": n})
    for b in (1, b_all):
        for stamped in (1, 0):
            comp, clens, cyc = launch(b, stamped)
            torch.cuda.synchronize()
            if not (torch.equal(comp, out[0][:b])
                    and torch.equal(clens, out[1][:b])):
                raise AssertionError(f"lz4 encode copy (stamped={stamped}, "
                                     f"{b} rows) differs from "
                                     "csrc/lz4_encode.cu")
            cyc = cyc.tolist()
            probes, matches = cyc[8], cyc[9]
            rec[f"rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                "probes": probes, "matches": matches,
                "cycles_a_probe": {
                    **{p: cyc[i] / probes
                       for i, p in enumerate(LZ4_PROBE_PARTS)},
                    "shuffles and test (a probe run)": cyc[6] / probes,
                    "whole row": cyc[7] / probes},
                "cycles_a_match": {p: cyc[i] / matches
                                   for i, p in LZ4_MATCH_PARTS.items()},
                "whole_row_cycles": cyc[7]}
        rec[f"rows_{b}_unstamped_ms"] = cs.cuda_ms(lambda: launch(b, 0), 3)
        rec[f"rows_{b}_kernel_ms"] = cs.cuda_ms(
            lambda: lz4_coder.lz4_encode_batch(blocks[:b], lens[:b], hl), 3)
    new = lib.tpz_lz4_step_clocks
    new.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, ci, ci, vp, ci]

    def launch_new(b: int, which: int, width: int):
        comp = torch.zeros((b, cap), dtype=torch.uint8, device="cuda")
        clens = torch.empty(b, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(10, dtype=torch.int64, device="cuda")
        _build.check(new(blocks.data_ptr(), lens.data_ptr(), b, n,
                         comp.data_ptr(), cap, clens.data_ptr(),
                         tables.data_ptr(), hl, width, cyc.data_ptr(),
                         which),
                     "lz4_step_clocks")
        return comp, clens, cyc

    for (which, table), width, b in itertools.product(
            ((3, "shared"), (2, "shared"), (1, "device"), (0, "device")),
            (32, 8), (1, 132, b_all)):
        comp, clens, cyc = launch_new(b, which, width)
        torch.cuda.synchronize()
        if not (torch.equal(comp, out[0][:b])
                and torch.equal(clens, out[1][:b])):
            raise AssertionError(f"redesigned lz4 step copy ({which}, "
                                 f"{b} rows) differs from "
                                 "csrc/lz4_encode.cu")
        cyc = cyc.tolist()
        steps, matches = cyc[8], cyc[9]
        name = f"new_{table}_width_{width}_rows_{b}_" + (
            "stamped" if which & 1 else "unstamped")
        rec[name] = {
            "steps": steps, "matches": matches,
            "cycles_a_step": {
                **{p: cyc[i] / steps
                   for i, p in enumerate(LZ4_STEP_PARTS)},
                "whole row": cyc[7] / steps},
            "cycles_a_match": {p: cyc[i] / matches
                               for i, p in LZ4_STEP_MATCH_PARTS.items()},
            "whole_row_cycles": cyc[7]}
        if not which & 1:
            rec[name + "_ms"] = cs.cuda_ms(
                lambda: launch_new(b, which, width), 3)


LZ4_DEC_PARTS = ("token load", "length extensions", "literal copy",
                 "offset load", "match copy", "syncwarps")
RLE_DEC_PARTS = ("byte load", "out_cap test and store", "compare",
                 "count bytes", "fill stores")


def old_decoders(lib, res) -> None:
    """The earlier lz4 and rle decoders' copies on their paths' rows (the
    smoke's 64 MiB corpus through tpuzip_torch.compress with no codec and
    with codec "rle", 1024 rows of 64 KiB), stamped on row 0 alone and
    beside the other 1023 rows, each held against the real decoder's bytes
    and statuses there, into res["lz4_decode"] and res["rle_decode"]: the
    lz4 copy's cycles a sequence by part, the rle copy's cycles a stream
    byte by part, and the unstamped copy's and the kernel's ms."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    fn = lib.tpz_decode_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, ci, ci]
    for codec, coder, parts in (("lz4", lz4_coder, LZ4_DEC_PARTS),
                                ("rle", rle_coder, RLE_DEC_PARTS)):
        blob = tpuzip_torch.compress(data, codec=codec)
        with cs.recorded(coder, f"{codec}_decode_batch") as calls:
            tpuzip_torch.decompress(blob)
        (args, _, out), = calls
        comp, clens, out_cap = args[:3]
        b_all, w = comp.shape

        def launch(b: int, stamped: int):
            got = torch.empty((b, out_cap), dtype=torch.uint8, device="cuda")
            st = torch.empty(b, dtype=torch.int64, device="cuda")
            cyc = torch.zeros(10, dtype=torch.int64, device="cuda")
            _build.check(fn(comp.data_ptr(), clens.data_ptr(), b, w,
                            got.data_ptr(), out_cap, st.data_ptr(),
                            cyc.data_ptr(), int(codec == "lz4"), stamped),
                         f"{codec}_decode_clocks")
            return got, st, cyc

        rec = res.setdefault(f"{codec}_decode", {
            "rows": [b_all, w], "out_cap": out_cap,
            "stream_bytes_row0": int(clens[0])})
        for b in (1, b_all):
            for stamped in (1, 0):
                got, st, cyc = launch(b, stamped)
                torch.cuda.synchronize()
                if not (torch.equal(got, out[0][:b])
                        and torch.equal(st, out[1][:b])):
                    raise AssertionError(f"{codec} decode copy (stamped="
                                         f"{stamped}, {b} rows) differs "
                                         f"from the kernel")
                cyc = cyc.tolist()
                steps = cyc[8]
                rec[f"rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                    "steps": steps, "matches_or_counts": cyc[9],
                    "cycles_a_step": {
                        **{p: cyc[i] / steps for i, p in enumerate(parts)},
                        "whole row": cyc[7] / steps},
                    "whole_row_cycles": cyc[7]}
            rec[f"rows_{b}_unstamped_ms"] = cs.cuda_ms(lambda: launch(b, 0),
                                                       3)
            rec[f"rows_{b}_kernel_ms"] = cs.cuda_ms(
                lambda: getattr(coder, f"{codec}_decode_batch")(
                    comp[:b], clens[:b], out_cap), 3)


LZ4_NEW_PARTS = ("staging and places", "jump tables and starts",
                 "lanes' sequences, scan and checks", "literals",
                 "match rounds", "bytes out", "sequences parsed alone")


def new_lz4_decoder(lib, res) -> None:
    """The redesigned lz4 decoder's copy, stamped by part on the lz4
    path's rows (row 0 alone and beside the other 1023), held against
    csrc/lz4_decode.cu's bytes and statuses there, into
    res["lz4_decode"]["redesign_*"]: cycles a sequence by part, and the
    batches, rounds and sequences parsed alone of row 0."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    fn = lib.tpz_lz4_decode_new_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, ci]
    blob = tpuzip_torch.compress(data)
    with cs.recorded(lz4_coder, "lz4_decode_batch") as calls:
        tpuzip_torch.decompress(blob)
    (args, _, out), = calls
    comp, clens, out_cap = args[:3]
    b_all, w = comp.shape

    def launch(b: int, stamped: int):
        got = torch.empty((b, out_cap), dtype=torch.uint8, device="cuda")
        st = torch.empty(b, dtype=torch.int64, device="cuda")
        cyc = torch.zeros(12, dtype=torch.int64, device="cuda")
        _build.check(fn(comp.data_ptr(), clens.data_ptr(), b, w,
                        got.data_ptr(), out_cap, st.data_ptr(),
                        cyc.data_ptr(), stamped), "lz4_decode_new_clocks")
        return got, st, cyc

    rec = res.setdefault("lz4_decode", {})
    for b in (1, b_all):
        for stamped in (1, 0):
            got, st, cyc = launch(b, stamped)
            torch.cuda.synchronize()
            if not (torch.equal(got, out[0][:b])
                    and torch.equal(st, out[1][:b])):
                raise AssertionError(f"redesigned lz4 decode copy (stamped="
                                     f"{stamped}, {b} rows) differs from "
                                     "the kernel")
            cyc = cyc.tolist()
            seqs = cyc[10] + cyc[11]
            rec[f"redesign_rows_{b}_"
                f"{'stamped' if stamped else 'unstamped'}"] = {
                "sequences": seqs, "batches": cyc[8], "rounds": cyc[9],
                "parsed_alone": cyc[10],
                "cycles_a_sequence": {
                    **{p: cyc[i] / seqs for i, p in enumerate(LZ4_NEW_PARTS)},
                    "whole row": cyc[7] / seqs},
                "whole_row_cycles": cyc[7]}
        rec[f"redesign_rows_{b}_unstamped_ms"] = cs.cuda_ms(
            lambda: launch(b, 0), 3)


CHAIN_PARTS = ("link loads", "cheap rejects", "extensions",
               "parse ballots, shuffles and lazy tests", "sequence writes")
DENSE_PARTS = ("4 bytes, hash and match_any", "table read", "table write",
               "verify load, filter and store", "closing syncwarp")


def chain_parse(lib, res) -> None:
    """The chained lz4 parse as it stood before its redesign, on the
    lz4_chain path's rows (the smoke's 64 MiB corpus through
    tpuzip_torch.compress at max_chain 8, 1024 rows of 64 KiB, hash_log
    16) and at max_chain 64 on the same links, stamped by part on row 0
    alone and beside the other 1023 rows, held against csrc/lz4_chain.cu's
    streams there, into res["lz4_chain_parse"]: cycles a window by part,
    the positions probed and read (the rest are the window's waste), the
    links walked for each, and the unstamped copy's and the kernel's ms."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    cfg = cs.Config()
    cfg.codec.lz4.max_chain = cs.CHAIN_PATH_DEPTH
    with cs.recorded(lz4_chain, "lz4_chain_links") as calls:
        tpuzip_torch.compress(data, config=cfg)
    (args, _, prev), = calls
    blocks, lens = args[0], args[1]
    b_all, n = blocks.shape
    fn = lib.tpz_chain_parse_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ci, ci, ci, vp, ci, vp, vp, ci]
    cap = lz4_coder.encode_cap(n)

    def launch(b: int, depth: int, stamped: int):
        comp = torch.zeros((b, cap), dtype=torch.uint8, device="cuda")
        clens = torch.empty(b, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(14, dtype=torch.int64, device="cuda")
        _build.check(fn(blocks.data_ptr(), lens.data_ptr(), prev.data_ptr(),
                        b, n, depth, comp.data_ptr(), cap, clens.data_ptr(),
                        cyc.data_ptr(), stamped), "chain_parse_clocks")
        return comp, clens, cyc

    rec = res.setdefault("lz4_chain_parse", {"rows": [b_all, n],
                                             "hash_log": 16})
    for depth in (cs.CHAIN_PATH_DEPTH, 64):
        words = lz4_chain.lz4_chain_best(blocks, lens, prev, depth)
        ref = lz4_chain.lz4_chain_parse(blocks, lens, prev, depth, words)
        for b in (1, b_all):
            for stamped in (1, 0):
                comp, clens, cyc = launch(b, depth, stamped)
                torch.cuda.synchronize()
                if not (torch.equal(comp, ref[0][:b])
                        and torch.equal(clens, ref[1][:b])):
                    raise AssertionError(
                        f"chained parse copy (max_chain {depth}, stamped="
                        f"{stamped}, {b} rows) differs from "
                        "csrc/lz4_chain.cu")
                cyc = cyc.tolist()
                windows = cyc[8]
                rec[f"max_chain_{depth}_rows_{b}_"
                    f"{'stamped' if stamped else 'unstamped'}"] = {
                    "windows": windows, "positions_probed": cyc[9],
                    "positions_read": cyc[10], "matches": cyc[11],
                    "links_walked": cyc[12], "links_walked_read": cyc[13],
                    "wasted_probe_share": 1 - cyc[10] / cyc[9],
                    "wasted_link_share": 1 - cyc[13] / max(cyc[12], 1),
                    "cycles_a_window": {
                        **{p: cyc[i] / windows
                           for i, p in enumerate(CHAIN_PARTS)},
                        "whole row": cyc[7] / windows},
                    "whole_row_cycles": cyc[7]}
            rec[f"max_chain_{depth}_rows_{b}_unstamped_ms"] = cs.cuda_ms(
                lambda: launch(b, depth, 0), 3)
            rec[f"max_chain_{depth}_rows_{b}_kernel_ms"] = cs.cuda_ms(
                lambda: lz4_chain.lz4_chain_parse(
                    blocks[:b], lens[:b], prev[:b], depth, words[:b]), 3)


def dense_candidates(lib, res) -> None:
    """The dense lz4 candidates step as it stood before its redesign (the
    keyed route at compress_from_device's 15 bits, a warp a row; since
    removed from csrc/lz4_dense.cu), on the serving path's tensor (1024
    rows of 64 KiB), stamped by part on row 0 alone and beside the other
    1023 rows, held against the plain candidates there, into
    res["lz4_dense_candidates"]: cycles a step by part and the unstamped
    copy's ms; and the same step on the direct route it took at 15 bits
    before it was keyed (2^15 int32 slots a row in device memory), into
    "direct_*"."""
    x, lens, _ = cs.serving_tensor()
    b_all, n = x.shape
    bits = lz4_dense.table_bits(lz4_dense.HASH_LOG)
    # the keyed table as its wrapper sized it: twice the hashes a row holds
    slog = max(6, min(bits + 1, (2 * n - 1).bit_length()))
    fn = lib.tpz_dense_candidates_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, vp, vp, ci, ci, ci, vp, ci]
    tables = torch.empty(b_all << slog, dtype=torch.int64, device="cuda")
    ref = lz4_dense.lz4_dense_candidates_plain(x, lens, lz4_dense.HASH_LOG)

    def launch(b: int, stamped: int, keyed: int = 1):
        cand = torch.empty((b, n), dtype=torch.int32, device="cuda")
        cyc = torch.zeros(10, dtype=torch.int64, device="cuda")
        _build.check(fn(x.data_ptr(), lens.data_ptr(), b, n, cand.data_ptr(),
                        tables.data_ptr(), bits, slog, keyed, cyc.data_ptr(),
                        stamped), "dense_candidates_clocks")
        return cand, cyc

    rec = res.setdefault("lz4_dense_candidates", {
        "rows": [b_all, n], "hash_log": lz4_dense.HASH_LOG,
        "slots_log": slog})
    for (keyed, name), b in itertools.product(((1, ""), (0, "direct_")),
                                              (1, b_all)):
        for stamped in (1, 0):
            cand, cyc = launch(b, stamped, keyed)
            torch.cuda.synchronize()
            if not torch.equal(cand, ref[:b]):
                raise AssertionError(f"dense candidates copy ({name}stamped="
                                     f"{stamped}, {b} rows) differs from "
                                     "the plain candidates")
            cyc = cyc.tolist()
            steps = cyc[8]
            rec[f"{name}rows_{b}_"
                f"{'stamped' if stamped else 'unstamped'}"] = {
                "steps": steps, "extra_slots_read": cyc[9],
                "cycles_a_step": {
                    **{p: cyc[i] / steps for i, p in enumerate(DENSE_PARTS)},
                    "whole row": cyc[7] / steps},
                "whole_row_cycles": cyc[7]}
        rec[f"{name}rows_{b}_unstamped_ms"] = cs.cuda_ms(
            lambda: launch(b, 0, keyed), 3)


def coders(lib, res) -> None:
    """The ari encoder's steps on the bwt and bwtdc rows, the apm bit
    decoder's and encoder's on the apm row, into res["ari_encode_*"],
    res["apm_decode"] and res["apm_encode"]."""
    data = cs.text_corpus(cs.BWT_BLOCK, cs.SEED)
    rows = {}
    for codec in ("bwt", "bwtdc"):
        with cs.recorded(range_coder, "ari_encode_indexed") as calls:
            tpuzip_torch.compress(data, codec=codec, block_size=cs.BWT_BLOCK)
        (args, _, _), = calls
        rows[codec] = (args[0][:1].contiguous(), args[1][:1])
    apm_data = data[: cs.BLOCK]
    blob = tpuzip_torch.compress(apm_data, codec="apm", block_size=cs.BLOCK)
    with cs.recorded(bin_coder, "bin_decode_indexed") as dcalls:
        tpuzip_torch.decompress(blob)
    (dargs, _, dout), = dcalls
    vp, ci = ctypes.c_void_p, ctypes.c_int
    enc = lib.tpz_ari_encode_clocks
    enc.argtypes = [vp, ci, vp, ci, vp, vp, vp, ci, ci, ci]
    dec = lib.tpz_apm_decode_clocks
    dec.argtypes = [vp, vp, ci, ci, vp, vp, ci, ci, ci]

    def run_enc(syms, lens, ref, stamped: int):
        out = torch.zeros(ref[0].shape[1], dtype=torch.uint8, device="cuda")
        drow = torch.zeros(ref[2].shape[1], dtype=torch.int32, device="cuda")
        slen = torch.zeros(1, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(8, dtype=torch.int64, device="cuda")
        _build.check(enc(syms.data_ptr(), int(lens[0]), out.data_ptr(),
                         out.numel(), drow.data_ptr(), slen.data_ptr(),
                         cyc.data_ptr(), *cs.KNOBS[0], stamped),
                     "ari_encode_clocks")
        torch.cuda.synchronize()
        return out, drow, slen, cyc.tolist()

    # the earlier step stamped by part and unstamped on the bwt row, the
    # redesign by warp on the bwt and bwtdc rows
    for codec, runs in (("bwt", (3, 2, 1, 0)), ("bwtdc", (2,))):
        syms, lens = rows[codec]
        n = int(lens[0])
        ref = range_coder.ari_encode_indexed(syms, lens)
        row = res.setdefault(f"ari_encode_{codec}", {"steps": n})
        for stamped in runs:
            out, drow, slen, cyc = run_enc(syms, lens, ref, stamped)
            if not (torch.equal(out, ref[0][0]) and torch.equal(slen, ref[1])
                    and torch.equal(drow, ref[2][0])):
                raise AssertionError(f"ari encode copy (stamped={stamped}) "
                                     f"differs from csrc/ari_encode.cu on "
                                     f"the {codec} row")
            row[("unstamped", "stamped", "redesign_by_warp",
                 "redesign_coder_step")[stamped]] = per_step(
                cyc, (ARI_PARTS, ARI_PARTS, WARP_PARTS, FINE_PARTS)[stamped],
                n)
        if 0 in runs:
            row["unstamped_ms"] = cs.cuda_ms(
                lambda: run_enc(syms, lens, ref, 0), 3)

    drows, dcap = dargs[0][:1].contiguous(), dargs[0].shape[1]
    ddeltas, nbits = dargs[1][:1].contiguous(), int(dargs[2][0])

    def run_dec(stamped: int):
        out = torch.zeros(dout.shape[1], dtype=torch.uint8, device="cuda")
        cyc = torch.zeros(8, dtype=torch.int64, device="cuda")
        _build.check(dec(drows.data_ptr(), ddeltas.data_ptr(), dcap, nbits,
                         out.data_ptr(), cyc.data_ptr(), *dargs[3:5],
                         stamped), "apm_decode_clocks")
        torch.cuda.synchronize()
        return out, cyc.tolist()

    nbytes = (nbits + 7) // 8
    for stamped in (1, 0):
        out, cyc = run_dec(stamped)
        if not torch.equal(out[:nbytes], dout[0, :nbytes]):
            raise AssertionError(f"apm decode copy (stamped={stamped}) "
                                 "differs from csrc/bin_decode.cu")
        res.setdefault("apm_decode", {"bits": nbits})[
            "stamped" if stamped else "unstamped"] = per_step(
                cyc, APM_PARTS, nbits)
    res["apm_decode"]["unstamped_ms"] = cs.cuda_ms(lambda: run_dec(0), 3)

    with cs.recorded(bin_coder, "bin_encode_indexed") as ecalls:
        tpuzip_torch.compress(apm_data, codec="apm", block_size=cs.BLOCK)
    (eargs, _, eout), = ecalls
    erow, elen = eargs[0][:1].contiguous(), int(eargs[1][0])
    apm_enc = lib.tpz_apm_encode_clocks
    apm_enc.argtypes = [vp, ci, vp, ci, vp, vp, vp, ci, ci, ci]

    def run_apm_enc(stamped: int):
        out = torch.zeros(eout[0].shape[1], dtype=torch.uint8, device="cuda")
        drow = torch.zeros(eout[2].shape[1], dtype=torch.int32, device="cuda")
        slen = torch.zeros(1, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(8, dtype=torch.int64, device="cuda")
        _build.check(apm_enc(erow.data_ptr(), elen, out.data_ptr(),
                             out.numel(), drow.data_ptr(), slen.data_ptr(),
                             cyc.data_ptr(), *eargs[2:4], stamped),
                     "apm_encode_clocks")
        torch.cuda.synchronize()
        return out, drow, slen, cyc.tolist()

    for stamped in (1, 0):
        out, drow, slen, cyc = run_apm_enc(stamped)
        if not (torch.equal(out, eout[0][0]) and torch.equal(drow, eout[2][0])
                and int(slen) == int(eout[1][0])):
            raise AssertionError(f"apm encode copy (stamped={stamped}) "
                                 "differs from csrc/bin_encode.cu")
        res.setdefault("apm_encode", {"bits": 8 * elen})[
            "stamped" if stamped else "unstamped"] = per_step(
                cyc, APM_ENC_PARTS, 8 * elen)
    res["apm_encode"]["unstamped_ms"] = cs.cuda_ms(lambda: run_apm_enc(0), 3)


INFLATE_PARTS = ("byte fill", "root lookup", "walk past the root",
                 "literal store", "extra bits and checks",
                 "match hand-off and copy", "headers, tables, stored")
INFLATE_NEW_PARTS = ("symbols", "scan and literal stores", "match rounds",
                     "bytes out", "headers, tables, staging, stored",
                     "bit window reads", "lookups")
PACK_PARTS = ("walk 1 sequence reads", "walk 1 sums", "header",
              "walk 2 sequence reads", "walk 2 column writes",
              "walk 2 literal copies")


def inflate(lib, res) -> None:
    """The deflate decoder as it stood before its redesign (lane 0
    decoding a symbol at a time, the warp copying each match), on the
    deflate path's rows (the smoke's 64 MiB corpus through
    tpuzip_torch.compress(codec="deflate"), 1024 streams of 64 KiB
    blocks), stamped by part on row 0 alone and beside the other 1023
    rows, held against csrc/inflate.cu's bytes and statuses there, into
    res["inflate"]: cycles a symbol by part, the symbols, matches and
    literals of row 0, and the unstamped copy's and the kernel's ms; and
    the redesigned kernel's copy likewise ("new_*": cycles a token by part,
    its batches and match rounds)."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    blob = tpuzip_torch.compress(data, codec="deflate")
    with cs.recorded(deflate_coder, "inflate_batch") as calls:
        tpuzip_torch.decompress(blob)
    (args, _, ref), = calls
    streams, lens, cap = args[0].contiguous(), args[1].contiguous(), args[2]
    b_all, w = streams.shape
    fn = lib.tpz_inflate_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, ci]

    def launch(b: int, stamped: int):
        out = torch.zeros((b, cap), dtype=torch.uint8, device="cuda")
        status = torch.empty(b, dtype=torch.int64, device="cuda")
        cyc = torch.zeros(11, dtype=torch.int64, device="cuda")
        _build.check(fn(streams.data_ptr(), lens.data_ptr(), b, w,
                        out.data_ptr(), cap, status.data_ptr(),
                        cyc.data_ptr(), stamped), "inflate_clocks")
        return out, status, cyc

    rec = res.setdefault("inflate", {"rows": [b_all, w], "out_cap": cap,
                                     "row0_stream_bytes": int(lens[0])})
    for b in (1, b_all):
        for stamped in (1, 0):
            out, status, cyc = launch(b, stamped)
            torch.cuda.synchronize()
            if not (torch.equal(out, ref[0][:b])
                    and torch.equal(status, ref[1][:b])):
                raise AssertionError(f"inflate copy (stamped={stamped}, "
                                     f"{b} rows) differs from "
                                     "csrc/inflate.cu")
            cyc = cyc.tolist()
            symbols = cyc[8]
            rec[f"rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                "symbols": symbols, "matches": cyc[9], "literals": cyc[10],
                "cycles_a_symbol": {
                    **{p: cyc[i] / symbols
                       for i, p in enumerate(INFLATE_PARTS)},
                    "whole row": cyc[7] / symbols},
                "whole_row_cycles": cyc[7]}
        rec[f"rows_{b}_unstamped_ms"] = cs.cuda_ms(lambda: launch(b, 0), 3)
        rec[f"rows_{b}_kernel_ms"] = cs.cuda_ms(
            lambda: deflate_coder.inflate_batch(streams[:b], lens[:b], cap),
            3)
    # the redesign (csrc/inflate.cu's kernel), by part a token
    new = lib.tpz_inflate_new_clocks
    new.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, ci]

    def launch_new(b: int, stamped: int):
        out = torch.zeros((b, cap), dtype=torch.uint8, device="cuda")
        status = torch.empty(b, dtype=torch.int64, device="cuda")
        cyc = torch.zeros(12, dtype=torch.int64, device="cuda")
        _build.check(new(streams.data_ptr(), lens.data_ptr(), b, w,
                         out.data_ptr(), cap, status.data_ptr(),
                         cyc.data_ptr(), stamped), "inflate_new_clocks")
        return out, status, cyc

    for b in (1, b_all):
        for stamped in (1, 0):
            out, status, cyc = launch_new(b, stamped)
            torch.cuda.synchronize()
            if not (torch.equal(out, ref[0][:b])
                    and torch.equal(status, ref[1][:b])):
                raise AssertionError(f"redesigned inflate copy (stamped="
                                     f"{stamped}, {b} rows) differs from "
                                     "csrc/inflate.cu")
            cyc = cyc.tolist()
            tokens = cyc[9]
            rec[f"new_rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                "batches": cyc[8], "tokens": tokens, "match_rounds": cyc[10],
                "matches": cyc[11],
                "cycles_a_token": {
                    **{p: cyc[i] / tokens
                       for i, p in enumerate(INFLATE_NEW_PARTS)},
                    "whole row": cyc[7] / tokens},
                "whole_row_cycles": cyc[7]}
        rec[f"new_rows_{b}_unstamped_ms"] = cs.cuda_ms(
            lambda: launch_new(b, 0), 3)


def lz4p_pack(lib, res) -> None:
    """lz4p's pack as it stood before its redesign (two walks of each LZ4
    stream, a sequence at a time from device memory), on the lz4p path's
    rows (the smoke's 64 MiB corpus through
    tpuzip_torch.compress(codec="lz4p"): lz4_encode.cu's streams of 1024
    blocks of 64 KiB, runs split), stamped by part on row 0 alone and
    beside the other 1023 rows, held against csrc/lz4p.cu's rows and
    lengths there, into res["lz4p_pack"]: cycles a sequence by part, the
    sequences and column entries of row 0, and the unstamped copy's and
    the kernel's ms."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    with cs.recorded(lz4p_coder, "lz4p_pack") as calls:
        tpuzip_torch.compress(data, codec="lz4p")
    (args, kw, ref), = calls
    comp, clens, n = args[0].contiguous(), args[1].contiguous(), args[2]
    split = kw.get("split", args[3] if len(args) > 3 else True)
    b_all, w = comp.shape
    cap = ref[0].shape[1]
    fn = lib.tpz_pack_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, vp, ci, vp, ci, vp, ci]

    def launch(b: int, stamped: int):
        out = torch.zeros((b, cap), dtype=torch.uint8, device="cuda")
        olens = torch.empty(b, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(10, dtype=torch.int64, device="cuda")
        _build.check(fn(comp.data_ptr(), clens.data_ptr(), b, w,
                        out.data_ptr(), cap, olens.data_ptr(), int(split),
                        cyc.data_ptr(), stamped), "pack_clocks")
        return out, olens, cyc

    rec = res.setdefault("lz4p_pack", {"rows": [b_all, w], "split": split,
                                       "row0_stream_bytes": int(clens[0])})
    for b in (1, b_all):
        for stamped in (1, 0):
            out, olens, cyc = launch(b, stamped)
            torch.cuda.synchronize()
            if not (torch.equal(out, ref[0][:b])
                    and torch.equal(olens, ref[1][:b])):
                raise AssertionError(f"lz4p pack copy (stamped={stamped}, "
                                     f"{b} rows) differs from "
                                     "csrc/lz4p.cu")
            cyc = cyc.tolist()
            seqs = cyc[8]
            rec[f"rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                "sequences": seqs, "entries": cyc[9],
                "cycles_a_sequence": {
                    **{p: cyc[i] / seqs for i, p in enumerate(PACK_PARTS)},
                    "whole row": cyc[7] / seqs},
                "whole_row_cycles": cyc[7]}
        rec[f"rows_{b}_unstamped_ms"] = cs.cuda_ms(lambda: launch(b, 0), 3)
        rec[f"rows_{b}_kernel_ms"] = cs.cuda_ms(
            lambda: lz4p_coder.lz4p_pack(comp[:b], clens[:b], n, split), 3)



LZ4P_DECODE_PARTS = ("pass 1", "pass 2 column entries", "shuffles",
                     "literals", "matches", "syncs", "zeros after the output")
LZ4P_NEW_PARTS = ("pass 1", "pass 2 column entries",
                  "literals and early matches", "match rounds", "bytes out",
                  "batches past the history", "zeros after the output")
LINKS_PARTS = ("bytes and hash", "ballot and __match_any_sync", "keyed_find",
               "keyed_put", "prev store", "table reset", "-1 past the limit")


def lz4p_decode(lib, res) -> None:
    """lz4p's decode as it stood before its redesign (a pass of prefix sums
    over the columns, then each sequence's literals and match in order), on
    the lz4p path's rows (the smoke's 64 MiB corpus through
    tpuzip_torch.compress(codec="lz4p"), then decompress), stamped by part
    on row 0 alone and beside the other 1023 rows, held against
    csrc/lz4p.cu's bytes and statuses there, into res["lz4p_decode"]:
    cycles a sequence by part, the sequences, literal and match bytes of
    row 0, and the unstamped copy's and the kernel's ms; and the
    redesigned kernel's copy likewise ("new_*": cycles a batch of 32
    sequences by part, its batches and match rounds)."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    blob = tpuzip_torch.compress(data, codec="lz4p")
    with cs.recorded(lz4p_coder, "lz4p_decode_batch") as calls:
        tpuzip_torch.decompress(blob)
    (args, _, ref), = calls
    comp, clens, cap = args[0].contiguous(), args[1].contiguous(), args[2]
    b_all, w = comp.shape
    fn = lib.tpz_lz4p_decode_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, ci]

    def launch(b: int, stamped: int):
        out = torch.empty((b, cap), dtype=torch.uint8, device="cuda")
        status = torch.empty(b, dtype=torch.int64, device="cuda")
        cyc = torch.zeros(11, dtype=torch.int64, device="cuda")
        _build.check(fn(comp.data_ptr(), clens.data_ptr(), b, w,
                        out.data_ptr(), cap, status.data_ptr(),
                        cyc.data_ptr(), stamped), "lz4p_decode_clocks")
        return out, status, cyc

    rec = res.setdefault("lz4p_decode", {"rows": [b_all, w], "out_cap": cap,
                                         "row0_stream_bytes": int(clens[0])})
    for b in (1, b_all):
        for stamped in (1, 0):
            out, status, cyc = launch(b, stamped)
            torch.cuda.synchronize()
            if not (torch.equal(out, ref[0][:b])
                    and torch.equal(status, ref[1][:b])):
                raise AssertionError(f"lz4p decode copy (stamped={stamped}, "
                                     f"{b} rows) differs from csrc/lz4p.cu")
            cyc = cyc.tolist()
            seqs = cyc[8]
            rec[f"rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                "sequences": seqs, "literal_bytes": cyc[9],
                "match_bytes": cyc[10],
                "cycles_a_sequence": {
                    **{p: cyc[i] / seqs
                       for i, p in enumerate(LZ4P_DECODE_PARTS)},
                    "whole row": cyc[7] / seqs},
                "whole_row_cycles": cyc[7]}
        rec[f"rows_{b}_unstamped_ms"] = cs.cuda_ms(lambda: launch(b, 0), 3)
        rec[f"rows_{b}_kernel_ms"] = cs.cuda_ms(
            lambda: lz4p_coder.lz4p_decode_batch(comp[:b], clens[:b], cap),
            3)
    # the redesign (csrc/lz4p.cu's kernel), by part a batch
    new = lib.tpz_lz4p_decode_new_clocks
    new.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, ci]

    def launch_new(b: int, stamped: int):
        out = torch.empty((b, cap), dtype=torch.uint8, device="cuda")
        status = torch.empty(b, dtype=torch.int64, device="cuda")
        cyc = torch.zeros(13, dtype=torch.int64, device="cuda")
        _build.check(new(comp.data_ptr(), clens.data_ptr(), b, w,
                         out.data_ptr(), cap, status.data_ptr(),
                         cyc.data_ptr(), stamped), "lz4p_decode_new_clocks")
        return out, status, cyc

    for b in (1, b_all):
        for stamped in (1, 0):
            out, status, cyc = launch_new(b, stamped)
            torch.cuda.synchronize()
            if not (torch.equal(out, ref[0][:b])
                    and torch.equal(status, ref[1][:b])):
                raise AssertionError(f"redesigned lz4p decode copy (stamped="
                                     f"{stamped}, {b} rows) differs from "
                                     "csrc/lz4p.cu")
            cyc = cyc.tolist()
            batches = cyc[8]
            rec[f"new_rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                "batches": batches, "match_rounds": cyc[9],
                "sequences": cyc[10], "literal_bytes": cyc[11],
                "early_matches": cyc[12],
                "cycles_a_batch": {
                    **{p: cyc[i] / batches
                       for i, p in enumerate(LZ4P_NEW_PARTS)},
                    "whole row": cyc[7] / batches},
                "whole_row_cycles": cyc[7]}
        rec[f"new_rows_{b}_unstamped_ms"] = cs.cuda_ms(
            lambda: launch_new(b, 0), 3)


def zlib_row():
    """Phase 18's input as its kernels take it: ZLIB_BYTES of the smoke's
    corpus as one row (codecs.deflate.deflate's row) and its length."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)[: cs.ZLIB_BYTES]
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(1, -1)
    return x.cuda(), torch.tensor([len(data)], dtype=torch.int32,
                                  device="cuda")


def deflate_links(lib, res) -> None:
    """The deflate links as they stood before their redesign (a warp a row,
    32 positions a step, a keyed table in device memory), on the deflate
    path's rows (the smoke's 64 MiB corpus through
    tpuzip_torch.compress(codec="deflate"), 1024 rows of 64 KiB), stamped
    by part on row 0 alone and beside the other 1023 rows (a table a row,
    as chip_smoke.keyed_table_count gives), and on phase 18's one 8 MiB row
    (zlib_row), held against the links there, into res["deflate_links"]:
    cycles a step of 32 positions by part, the steps and extra probes of
    row 0, and the unstamped copy's and the checkout's links' ms (the
    path's route: the shared one at its 64 KiB rows, the tiled one on the
    8 MiB row)."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    with cs.recorded(deflate_coder, "deflate_links_shared") as calls:
        tpuzip_torch.compress(data, codec="deflate")
    (args, _, ref), = calls
    fn = lib.tpz_deflate_links_clocks
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, vp, vp, ci, ci, vp, ci]

    def launch(blocks, lens, stamped: int):
        b, n = blocks.shape
        slog = cs.keyed_slots_log(n)
        ntab = cs.keyed_table_count(b, n)
        tables = torch.empty(ntab * (cs.KEY_SLOT << slog) // 4,
                             dtype=torch.int32, device="cuda")
        prev = torch.empty((b, n), dtype=torch.int32, device="cuda")
        cyc = torch.zeros(10, dtype=torch.int64, device="cuda")
        _build.check(fn(blocks.data_ptr(), lens.data_ptr(), b, n,
                        prev.data_ptr(), tables.data_ptr(), ntab, slog,
                        cyc.data_ptr(), stamped), "deflate_links_clocks")
        return prev, cyc

    blocks, lens = args[0].contiguous(), args[1].contiguous()
    row, row_len = zlib_row()
    rec = res.setdefault("deflate_links", {
        "rows": list(blocks.shape), "slots_log": cs.keyed_slots_log(
            blocks.shape[1]), "zlib_row": list(row.shape)})
    for name, x, xl, want in (
            ("rows_1", blocks[:1], lens[:1], ref[:1]),
            (f"rows_{blocks.shape[0]}", blocks, lens, ref),
            ("zlib_row", row, row_len,
             deflate_coder.deflate_links_plain(row, row_len))):
        for stamped in (1, 0):
            prev, cyc = launch(x, xl, stamped)
            torch.cuda.synchronize()
            if not torch.equal(prev, want):
                raise AssertionError(f"deflate links copy (stamped="
                                     f"{stamped}, {name}) differs from the "
                                     "plain links")
            cyc = cyc.tolist()
            steps = cyc[8]
            rec[f"{name}_{'stamped' if stamped else 'unstamped'}"] = {
                "steps": steps, "extra_probes": cyc[9],
                "cycles_a_step": {
                    **{p: cyc[i] / steps for i, p in enumerate(LINKS_PARTS)},
                    "whole row": cyc[7] / steps},
                "whole_row_cycles": cyc[7]}
        rec[f"{name}_unstamped_ms"] = cs.cuda_ms(
            lambda: launch(x, xl, 0), 3)
        rec[f"{name}_kernel_ms"] = cs.cuda_ms(
            lambda: deflate_coder.deflate_links(x, xl), 3)
        rec[f"{name}_kernel_route"] = deflate_coder.links_route(x.shape[1])
        if not torch.equal(deflate_coder.deflate_links(x, xl), want):
            raise AssertionError(f"the checkout's links on {name} differ "
                                 "from the plain links")


GREEDY_PARTS = ("window loads", "ballot and shuffles",
                "literal loads and stores", "match token and jump")


def deflate_parse_greedy(lib, res) -> None:
    """The deflate device rule's greedy parse as it stood before its
    redesign (a warp a row over windows of 32 best values in device
    memory), stamped by part on the serving path's tensor
    (chip_smoke.serving_tensor(), 1024 rows of 64 KiB) row 0 alone and
    beside the other 1023 rows, and on phase 18's one 8 MiB row
    (zlib_row), over csrc/deflate_encode.cu's best at max_chain 1 (the
    source's best kernel, launched alone), held against the checkout's
    deflate_parse_greedy there, into res["deflate_parse_greedy"]: cycles a
    token by part, the tokens, matches and windows of row 0, and the
    unstamped copy's ms beside the checkout's parse's alone (its
    launches after the best kernel) and with the best kernel."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.tpz_deflate_greedy_clocks
    fn.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp, ci]
    best_fn = lib.tpz_deflate_best_source
    best_fn.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    new_fn = lib.tpz_deflate_segments_source
    new_fn.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp]
    size = lib.tpz_deflate_parse_scratch_source
    size.argtypes, size.restype = [ci, ci], ctypes.c_longlong

    def best_of(x, xl):
        b, n = x.shape
        prev = deflate_coder.deflate_links(x, xl)
        best_at = torch.empty((b, n), dtype=torch.int32, device="cuda")
        _build.check(best_fn(x.data_ptr(), xl.data_ptr(), prev.data_ptr(),
                             b, n, 1, best_at.data_ptr()),
                     "deflate_best_source")
        return prev, best_at

    def launch(x, xl, best_at, stamped: int):
        b, n = x.shape
        tok = torch.zeros((b, n), dtype=torch.int32, device="cuda")
        nt = torch.empty(b, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(11, dtype=torch.int64, device="cuda")
        _build.check(fn(x.data_ptr(), xl.data_ptr(), best_at.data_ptr(), b,
                        n, tok.data_ptr(), nt.data_ptr(), cyc.data_ptr(),
                        stamped), "deflate_greedy_clocks")
        return tok, nt, cyc

    def segments(x, xl, best_at):
        b, n = x.shape
        tok = torch.zeros((b, n), dtype=torch.int32, device="cuda")
        nt = torch.empty(b, dtype=torch.int32, device="cuda")
        scratch = torch.empty(size(b, n), dtype=torch.uint8, device="cuda")
        _build.check(new_fn(x.data_ptr(), xl.data_ptr(), best_at.data_ptr(),
                            b, n, tok.data_ptr(), nt.data_ptr(),
                            scratch.data_ptr()), "deflate_segments_source")
        return tok, nt

    x, lens, _ = cs.serving_tensor()
    row, row_len = zlib_row()
    rec = res.setdefault("deflate_parse_greedy", {"rows": list(x.shape),
                                                  "zlib_row": list(row.shape)})
    for name, xs, xl in (("rows_1", x[:1], lens[:1]),
                         (f"rows_{x.shape[0]}", x, lens),
                         ("zlib_row", row, row_len)):
        prev, best_at = best_of(xs, xl)
        want = deflate_coder.deflate_parse_greedy(xs, xl, prev)
        for stamped in (1, 0):
            tok, nt, cyc = launch(xs, xl, best_at, stamped)
            torch.cuda.synchronize()
            if not (torch.equal(tok, want[0]) and torch.equal(nt, want[1])):
                raise AssertionError(f"greedy parse copy (stamped="
                                     f"{stamped}, {name}) differs from the "
                                     "checkout's")
            cyc = cyc.tolist()
            tokens = max(cyc[8], 1)
            rec[f"{name}_{'stamped' if stamped else 'unstamped'}"] = {
                "tokens": cyc[8], "matches": cyc[9], "windows": cyc[10],
                "cycles_a_token": {
                    **{p: cyc[i] / tokens for i, p in enumerate(GREEDY_PARTS)},
                    "whole row": cyc[7] / tokens},
                "whole_row_cycles": cyc[7]}
        rec[f"{name}_unstamped_ms"] = cs.cuda_ms(
            lambda: launch(xs, xl, best_at, 0), 3 if name != "zlib_row"
            else 1)
        rec[f"{name}_kernel_with_best_ms"] = cs.cuda_ms(
            lambda: deflate_coder.deflate_parse_greedy(xs, xl, prev), 3)
        got = segments(xs, xl, best_at)
        if not all(torch.equal(a, c) for a, c in zip(got, want)):
            raise AssertionError(f"the segment parse on {name} differs")
        rec[f"{name}_kernel_ms"] = cs.cuda_ms(
            lambda: segments(xs, xl, best_at), 3)


TABLE_PARTS = ("histograms", "literal tree: partitions",
               "literal tree: final insertion sort",
               "literal tree: heap-sort fallback",
               "literal tree: level items", "literal tree: level stores",
               "literal tree: marking", "distance tree",
               "lengths run-length coded, code-length tree",
               "fixes, codes, header bits and record store")
NEW_TABLE_PARTS = ("histograms", "level packages, test and items",
                   "warp partitions", "final ranges' pass", "level stores",
                   "marking", "wait for the other tree", "fixes",
                   "header (warp 0) or codes (warp 1)", "record store")
NEW_TABLE_COUNTERS = ("levels sorted", "levels skipped", "warp partitions",
                      "final ranges of 2 or more", "heap sorts")
TABLE_LEVEL_BYTES = 20480   # tables_old::LEVEL_BYTES: a row's levels' orders
TABLE_COUNTERS = ("literal levels sorted", "literal items sorted",
                  "literal partitions of 17-32 items",
                  "literal partitions of 33-64 items",
                  "literal partitions past 64 items",
                  "literal heap sorts",
                  "literal levels whose items equal the previous level's",
                  "distance levels whose items equal the previous level's",
                  "distance items sorted")


def deflate_tables(lib, res) -> None:
    """The deflate tables as they stood before their redesign (a warp a
    row, lane 0's package-merge with the std::sort replica, the levels'
    orders in device memory), on the deflate path's tokens (the smoke's
    64 MiB corpus through tpuzip_torch.compress(codec="deflate"), 1024
    rows of 64 KiB, dynamic at max_chain 128), stamped by part on row 0
    alone and beside the other 1023 rows, each copy's records held against
    csrc/deflate_encode.cu's own (built into the same library) and its
    streams, through the source's emit kernel, against the path's, into
    res["deflate_tables"]: cycles of row 0 by part, its counters, and the
    unstamped copy's ms (its tables alone, and with the emit) beside the
    path's launch (tables and emit) on the same rows; and the redesigned
    kernel's copy likewise ("new_*": cycles of row 0 by part on each of
    its two warps, and counters)."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    with cs.recorded(deflate_coder, "deflate_emit") as calls:
        tpuzip_torch.compress(data, codec="deflate")
    (args, _, ref), = calls
    blocks, lens = args[0].contiguous(), args[1].contiguous()
    tokens, ntok, mode = args[2].contiguous(), args[3].contiguous(), args[4]
    b_all, n = tokens.shape
    cap = ref[0].shape[1]
    layout = (ctypes.c_int * 3)()
    lib.tpz_deflate_record_layout(layout)
    row_bytes, rec_from, rec_to = layout
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.tpz_deflate_tables_clocks
    fn.argtypes = [vp, vp, ci, ci, ci, vp, ci, vp, vp, vp, vp, ci, ci]
    src = lib.tpz_deflate_emit_source
    src.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, ci, vp, vp, vp]

    def outputs(b: int):
        return (torch.zeros((b, cap), dtype=torch.uint8, device="cuda"),
                torch.empty(b, dtype=torch.int32, device="cuda"),
                torch.zeros((b, row_bytes), dtype=torch.uint8,
                            device="cuda"))

    def launch(b: int, stamped: int, emit: int = 1):
        comp, clens, scratch = outputs(b)
        levels = torch.empty(b * TABLE_LEVEL_BYTES, dtype=torch.uint8,
                             device="cuda")
        cyc = torch.zeros(32, dtype=torch.int64, device="cuda")
        _build.check(fn(tokens.data_ptr(), ntok.data_ptr(), b, n, mode,
                        comp.data_ptr(), cap, clens.data_ptr(),
                        scratch.data_ptr(), levels.data_ptr(),
                        cyc.data_ptr(), stamped, emit),
                     "deflate_tables_clocks")
        return comp, clens, scratch, cyc

    def source(b: int):
        comp, clens, scratch = outputs(b)
        _build.check(src(blocks.data_ptr(), lens.data_ptr(),
                         tokens.data_ptr(), ntok.data_ptr(), b, n, mode,
                         comp.data_ptr(), cap, clens.data_ptr(),
                         scratch.data_ptr(), None), "deflate_emit_source")
        return comp, clens, scratch

    rec = res.setdefault("deflate_tables", {
        "rows": [b_all, n], "mode": mode,
        "row0_tokens": int(ntok[0]), "record_bytes": rec_to - rec_from})
    for b in (1, b_all):
        scomp, sclens, sscratch = source(b)
        for stamped in (1, 0):
            comp, clens, scratch, cyc = launch(b, stamped)
            torch.cuda.synchronize()
            same = (torch.equal(comp, ref[0][:b])
                    and torch.equal(clens, ref[1][:b])
                    and torch.equal(scomp, ref[0][:b])
                    and torch.equal(scratch[:, rec_from:rec_to],
                                    sscratch[:, rec_from:rec_to]))
            if not same:
                raise AssertionError(f"deflate tables copy (stamped="
                                     f"{stamped}, {b} rows) differs from "
                                     "csrc/deflate_encode.cu")
            cyc = cyc.tolist()
            whole = cyc[len(TABLE_PARTS)]
            rec[f"rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                "cycles": {**{p: cyc[i] for i, p in enumerate(TABLE_PARTS)},
                           "whole row": whole},
                "counters": {c: cyc[len(TABLE_PARTS) + 1 + i]
                             for i, c in enumerate(TABLE_COUNTERS)}}
        rec[f"rows_{b}_unstamped_tables_ms"] = cs.cuda_ms(
            lambda: launch(b, 0, 0), 3)
        rec[f"rows_{b}_unstamped_ms"] = cs.cuda_ms(lambda: launch(b, 0), 3)
        rec[f"rows_{b}_kernel_ms"] = cs.cuda_ms(
            lambda: deflate_coder.deflate_emit(blocks[:b], lens[:b],
                                               tokens[:b], ntok[:b], mode),
            3)
    # the redesign (csrc/deflate_encode.cu's kernel), by part on each warp
    new = lib.tpz_deflate_tables_new_clocks
    new.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, vp, ci, ci]

    def launch_new(b: int, stamped: int, emit: int = 1):
        comp, clens, scratch = outputs(b)
        cyc = torch.zeros(32, dtype=torch.int64, device="cuda")
        _build.check(new(tokens.data_ptr(), ntok.data_ptr(), b, n,
                         comp.data_ptr(), cap, clens.data_ptr(),
                         scratch.data_ptr(), cyc.data_ptr(), stamped, emit),
                     "deflate_tables_new_clocks")
        return comp, clens, scratch, cyc

    for b in (1, b_all):
        scomp, sclens, sscratch = source(b)
        for stamped in (1, 0):
            comp, clens, scratch, cyc = launch_new(b, stamped)
            torch.cuda.synchronize()
            if not (torch.equal(comp, ref[0][:b])
                    and torch.equal(clens, ref[1][:b])
                    and torch.equal(scratch[:, rec_from:rec_to],
                                    sscratch[:, rec_from:rec_to])):
                raise AssertionError(f"redesigned deflate tables copy "
                                     f"(stamped={stamped}, {b} rows) "
                                     "differs from csrc/deflate_encode.cu")
            cyc = cyc.tolist()
            rec[f"new_rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                f"warp_{w}": {
                    "cycles": {**{p: cyc[16 * w + i]
                                  for i, p in enumerate(NEW_TABLE_PARTS)},
                               "whole row": cyc[16 * w + 10]},
                    "counters": {c: cyc[16 * w + 11 + i]
                                 for i, c in enumerate(NEW_TABLE_COUNTERS)}}
                for w in (0, 1)}
        rec[f"new_rows_{b}_unstamped_tables_ms"] = cs.cuda_ms(
            lambda: launch_new(b, 0, 0), 3)


TUPLE_PARTS = ("histograms", "leaves' rank", "levels' ranking",
               "offsets scan", "pool build", "lengths' count",
               "wait for the other tree", "fixes",
               "header (warp 0) or codes (warp 1)", "record store")
TUPLE_COUNTERS = ("active symbols", "levels", "items ranked",
                  "pool symbols written", "equal-weight tuple compares")


def deflate_tables_tuple(lib, res) -> None:
    """The device rule's tables as they stood before their redesign
    (deflate_tables_kernel<TupleShared>: a CTA of two warps a row, the
    levels' tuples in pools of shared memory), stamped by part on each
    warp: on the serving path's tokens (the serving tensor through
    compress_from_device(codec="deflate"), 1024 rows of 64 KiB) row 0
    alone and beside the other 1023 rows, and on phase 18's one 8 MiB row;
    each copy's records held against csrc/deflate_encode.cu's own
    (tpz_deflate_emit_tuple into a scratch of this section's) and its
    streams, through the source's row emit kernel, against the path's;
    then the unstamped copy's ms (tables alone) beside the source's
    launch (tables and emit), and the CTAs an SM of each tables instance
    and emit kernel with their static shared memory."""
    x, lens, _ = cs.serving_tensor()
    with cs.recorded(deflate_coder, "deflate_emit_tuple") as calls:
        tpuzip_torch.compress_from_device(x, lens, codec="deflate")
    (args, _, ref), = calls
    inputs = {"serving": (args[2].contiguous(), args[3].contiguous(), ref)}
    row, row_len = zlib_row()
    with cs.recorded(deflate_coder, "deflate_emit_tuple") as calls:
        deflate_coder.deflate_emit_tuple(
            row, row_len, *deflate_coder.deflate_parse_greedy(
                row, row_len, deflate_coder.deflate_links(row, row_len)))
    (args, _, ref), = calls
    inputs["zlib_row"] = (args[2].contiguous(), args[3].contiguous(), ref)
    layout = (ctypes.c_int * 3)()
    lib.tpz_deflate_record_layout(layout)
    row_bytes, rec_from, rec_to = layout
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.tpz_deflate_tables_tuple_clocks
    fn.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, vp, ci, ci]
    src = lib.tpz_deflate_emit_tuple_source
    src.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, vp]
    rec = res.setdefault("deflate_tables_tuple", {})
    for name, (tokens, ntok, ref) in inputs.items():
        b_all, n = tokens.shape
        cap = ref[0].shape[1]

        def outputs(b):
            return (torch.zeros((b, cap), dtype=torch.uint8, device="cuda"),
                    torch.empty(b, dtype=torch.int32, device="cuda"),
                    torch.zeros((b, row_bytes), dtype=torch.uint8,
                                device="cuda"))

        def launch(b, stamped, emit=1):
            comp, clens, scratch = outputs(b)
            cyc = torch.zeros(32, dtype=torch.int64, device="cuda")
            _build.check(fn(tokens.data_ptr(), ntok.data_ptr(), b, n,
                            comp.data_ptr(), cap, clens.data_ptr(),
                            scratch.data_ptr(), cyc.data_ptr(), stamped,
                            emit), "deflate_tables_tuple_clocks")
            return comp, clens, scratch, cyc

        def source(b):
            comp, clens, _ = outputs(b)
            scratch = torch.zeros(
                int(deflate_coder._emit_scratch_bytes(b, n)),
                dtype=torch.uint8, device="cuda")
            _build.check(src(tokens.data_ptr(), ntok.data_ptr(), b, n,
                             comp.data_ptr(), cap, clens.data_ptr(),
                             scratch.data_ptr(), None),
                         "deflate_emit_tuple_source")
            return comp, clens, scratch[: b * row_bytes].view(b, row_bytes)

        out = rec.setdefault(name, {"rows": [b_all, n],
                                    "row0_tokens": int(ntok[0])})
        for b in sorted({1, b_all}):
            scomp, sclens, sscratch = source(b)
            for stamped in (1, 0):
                comp, clens, scratch, cyc = launch(b, stamped)
                torch.cuda.synchronize()
                if not (torch.equal(comp, ref[0][:b])
                        and torch.equal(clens, ref[1][:b])
                        and torch.equal(scomp, ref[0][:b])
                        and torch.equal(scratch[:, rec_from:rec_to],
                                        sscratch[:, rec_from:rec_to])):
                    raise AssertionError(
                        f"the tuple tables' copy (stamped={stamped}, {b} "
                        f"rows of {name}) differs from "
                        "csrc/deflate_encode.cu")
                cyc = cyc.tolist()
                out[f"rows_{b}_{'stamped' if stamped else 'unstamped'}"] = {
                    f"warp_{w}": {
                        "cycles": {**{p: cyc[16 * w + i]
                                      for i, p in enumerate(TUPLE_PARTS)},
                                   "whole row": cyc[16 * w + 10]},
                        "counters": {c: cyc[16 * w + 11 + i]
                                     for i, c in enumerate(TUPLE_COUNTERS)}}
                    for w in (0, 1)}
            out[f"rows_{b}_unstamped_tables_ms"] = cs.cuda_ms(
                lambda: launch(b, 0, 0), 3)
            out[f"rows_{b}_source_ms"] = cs.cuda_ms(lambda: source(b), 3)
    lib.tpz_deflate_tables_kernels.restype = ctypes.c_char_p
    names = lib.tpz_deflate_tables_kernels().decode().split(",")
    occ = (ctypes.c_int * (2 * len(names)))()
    _build.check(lib.tpz_deflate_tables_occupancy(occ),
                 "deflate_tables_occupancy")
    rec["ctas_an_sm"] = {
        name: {"ctas": occ[2 * i], "static_shared_bytes": occ[2 * i + 1]}
        for i, name in enumerate(names)}


SECTIONS = {"coders": coders, "dc_walk": dc_walk, "lz4_encode": lz4_probe,
            "lz4_decode": lambda lib, res: (old_decoders(lib, res),
                                            new_lz4_decoder(lib, res)),
            "lz4_chain": chain_parse, "lz4_dense": dense_candidates,
            "inflate": inflate, "lz4p_pack": lz4p_pack,
            "lz4p_decode": lz4p_decode, "deflate_links": deflate_links,
            "deflate_tables": deflate_tables,
            "deflate_tables_tuple": deflate_tables_tuple,
            "deflate_parse_greedy": deflate_parse_greedy}


def main(names: list) -> int:
    """python3 tools/step_clocks.py [SECTION ...]: every section of
    SECTIONS, or the named ones (lz4_chain and lz4_dense: about 30 s)."""
    if not torch.cuda.is_available():
        print("step_clocks: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    unknown = set(names) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"step_clocks: no section {sorted(unknown)}; "
                         f"the sections are {list(SECTIONS)}")
    res = {"nvidia_smi": cs.nvidia_smi()}
    with tempfile.TemporaryDirectory() as tmp:
        so = f"{tmp}/step_clocks.so"
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(ROOT, "tools", "step_clocks.cu")],
                       check=True, timeout=600)
        lib = ctypes.CDLL(so)
    for name in names or SECTIONS:
        SECTIONS[name](lib, res)
        print(json.dumps({name: {k: v for k, v in res.items()
                                 if k != "nvidia_smi"}}), flush=True)
        res = {"nvidia_smi": res["nvidia_smi"]}
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
