#!/usr/bin/env python3
"""Check and time csrc/deflate_encode.cu and csrc/inflate.cu on one GPU:

    python3 tools/deflate_kernels.py [--ab DIR ... | --wide | --routes]

Builds both sources with nvcc -Xptxas -v (registers and spills), then
holds every launch exact against its plain version on 40 rows of 4 KiB
(text, zeros, random bytes, 3 and 6 symbols, b"ab", at lengths 4096,
4095, 1365, 777 and 4, one row of each length with random bytes past
it, and text rows of 0, 1, 2, 3, 5, 259, 260 and 1000 bytes) and on 40
KiB rows whose repeats lie 32,767 to 32,769 back: the links, the parse
at max_chain 1, 8 and 128, the emit in the three modes, tpuzip's device
rule (the greedy parse at max_chain 1, the tables in the tuple order),
and the inflate of every stream; both table orders also on chip_smoke's
table rows (each stream read back by zlib); the inflate also on 64 random
and 64 bit-flipped streams and zlib's streams of several blocks.  Then
one timed launch of each (CUDA events) at 1024 x 64 KiB of chip_smoke's
text corpus, dynamic at max_chain 128, and the device rule's two.  With --ab, each DIR's deflate_encode.cu parse entry
(tpz_deflate_parse, with or without its best_at scratch argument) against
the checkout's, outputs held equal, timed in turns (DIR, checkout,
checkout, DIR) at 1024 x 64 KiB of text at max_chain 8 and 128, of zero
rows and of random rows at 128.  With --wide, after the build only phase 18's four
launches on its one 8 MiB row, each alone, and the links at the wide
path's 64 x 128 KiB with the C++ rule's tables and emit there (wide()),
then each kernel's device ms of the greedy parse, of the tuple tables
with the emit (at 1024 x 64 KiB of text and on the 8 MiB row), of those
links and of the C++ rule's tables with the emit at the wide path from
one traced call (parts()).  Prints the card, the ptxas lines and one
JSON line a group.  With --routes, only routes() (no ptxas lines): the
tables with the emit at 1024 x 64 KiB on the checkout's row route against
builds of the same source that take the tiled route there
(ROUTE_PATCHES)."""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tpuzip_torch.kernels import _build, deflate_coder as dc  # noqa: E402


def ptxas() -> None:
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("deflate_encode", "inflate"):
            r = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 f"{tmp}/{name}.so", str(_build.CSRC / f"{name}.cu")],
                capture_output=True, text=True, timeout=300)
            print(name, r.returncode, "\n".join(
                line for line in (r.stdout + r.stderr).splitlines()
                if "registers" in line or "error" in line
                or "spill" in line or "smem" in line
                or "entry function" in line), flush=True)
    _build.build("deflate_encode", "inflate")


def rows(n: int):
    """(40, n) rows and lengths on the card, as the module note says."""
    rng = np.random.default_rng(5)
    text = np.frombuffer(cs.text_corpus(8 * n, 3), np.uint8)
    kinds = [text[:n], text[n : 2 * n], np.zeros(n), rng.integers(0, 256, n),
             rng.integers(0, 3, n), rng.integers(0, 6, n) * 37,
             np.resize(np.frombuffer(b"ab", np.uint8), n), text[2 * n : 3 * n]]
    out, lens = [], []
    for k, row in enumerate(kinds * 4):
        out.append(np.asarray(row, np.uint8))
        lens.append([n, n - 1, n // 3, 777, 4][k // len(kinds)]
                    if k % len(kinds) != 1 else n // 2)
    for ln in (0, 1, 2, 3, 5, 259, 260, 1000):
        out.append(text[:n].copy())
        lens.append(ln)
    x = np.stack(out)
    keep = np.arange(n)[None, :] < np.array(lens)[:, None]
    x = np.where(keep | (np.arange(len(x)) % 5 == 1)[:, None], x, 0)
    return (torch.from_numpy(x.astype(np.uint8)).cuda(),
            torch.tensor(lens, dtype=torch.int32).cuda())


def far_rows():
    """Rows of 40 KiB whose second copy of a 300-byte run lies 32,767,
    32,768 and 32,769 bytes after the first."""
    rng = np.random.default_rng(9)
    n = 40 << 10
    out = []
    for gap in (32767, 32768, 32769):
        row = rng.integers(0, 256, n).astype(np.uint8)
        row[gap : gap + 300] = row[:300]
        out.append(row)
    x = torch.from_numpy(np.stack(out)).cuda()
    return x, torch.full((3,), n, dtype=torch.int32).cuda()


def check(x, xl, label: str) -> dict:
    res = {"rows": list(x.shape)}
    prev = dc.deflate_links(x, xl)
    pref = dc.deflate_links_plain(x, xl)
    res["links_err"] = cs.max_err(prev, pref)
    streams = []
    for mc in (1, 8, 128):
        tok, nt = dc.deflate_parse(x, xl, prev, mc)
        tref, ntref = dc.deflate_parse_plain(x, xl, pref, mc)
        res[f"parse_{mc}_err"] = max(cs.max_err(tok, tref),
                                     cs.max_err(nt, ntref))
        for mode in (0, 1):
            comp, clens = dc.deflate_emit(x, xl, tok, nt, mode)
            cref, clref = dc.deflate_emit_plain(x, xl, tref, ntref, mode)
            res[f"emit_{mode}_{mc}_err"] = max(cs.max_err(comp, cref),
                                               cs.max_err(clens, clref))
            streams.append((comp, clens))
    comp, clens = dc.deflate_emit(x, xl, None, None, 2)
    cref, clref = dc.deflate_emit_plain(x, xl, None, None, 2)
    res["emit_stored_err"] = max(cs.max_err(comp, cref),
                                 cs.max_err(clens, clref))
    streams.append((comp, clens))
    tok, nt = dc.deflate_parse_greedy(x, xl, prev)
    tref, ntref = dc.deflate_parse_plain(x, xl, pref, 1, greedy=True)
    res["parse_greedy_err"] = max(cs.max_err(tok, tref),
                                  cs.max_err(nt, ntref))
    comp, clens = dc.deflate_emit_tuple(x, xl, tok, nt)
    cref, clref = dc.deflate_emit_plain(x, xl, tref, ntref, 0, "tuple")
    res["emit_tuple_err"] = max(cs.max_err(comp, cref),
                                cs.max_err(clens, clref))
    streams.append((comp, clens))
    n = x.shape[1]
    keep = torch.arange(n, device="cuda")[None, :] < xl[:, None]
    want = torch.where(keep, x, 0)
    for k, (comp, clens) in enumerate(streams):
        out, st = dc.inflate_batch(comp, clens, n)
        oref, sref = dc.inflate_batch_plain(comp, clens, n)
        res[f"inflate_{k}_err"] = max(cs.max_err(out, oref),
                                      cs.max_err(st, sref))
        res[f"inflate_{k}_round_trip"] = bool(
            torch.equal(st, xl.to(torch.int64)) and torch.equal(out, want))
    print(json.dumps({"group": label, **res}), flush=True)
    return res


def tables() -> dict:
    """Both table orders on chip_smoke's table rows, exact against the
    plain emit, each stream read back by zlib."""
    import zlib
    res = {}
    for group, (tok, nt, raw, rl, names) in cs.table_rows(cs.SEED + 24).items():
        for order in ("std", "tuple"):
            comp, clens = (dc.deflate_emit(raw, rl, tok, nt, 0)
                           if order == "std" else
                           dc.deflate_emit_tuple(raw, rl, tok, nt))
            cref, clref = dc.deflate_emit_plain(raw, rl, tok, nt, 0, order)
            c, cl = comp.cpu().numpy(), clens.tolist()
            rows = raw.cpu().numpy()
            res[f"{group}_{order}"] = {
                "err": max(cs.max_err(comp, cref), cs.max_err(clens, clref)),
                "zlib": all(zlib.decompress(c[r, : cl[r]].tobytes(), -15)
                            == rows[r, : int(rl[r])].tobytes()
                            for r in range(len(names)))}
    print(json.dumps({"group": "tables", **res}), flush=True)
    return res


def garbage() -> dict:
    rng = np.random.default_rng(11)
    text = cs.text_corpus(3000, 4)
    import zlib
    streams = [rng.integers(0, 256, int(rng.integers(1, 300)),
                            dtype=np.uint8).tobytes() for _ in range(64)]
    good = zlib.compress(text, 6)[2:-4]
    for k in range(64):
        s = bytearray(good)
        s[int(rng.integers(0, len(s)))] ^= 1 << int(rng.integers(0, 8))
        streams.append(bytes(s))
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    multi = b""
    for k in range(6):
        multi += co.compress(text[k * 400 : (k + 1) * 400])
        multi += co.flush(zlib.Z_SYNC_FLUSH if k % 2 else zlib.Z_FULL_FLUSH)
    multi += co.flush()
    streams += [multi, multi[:-3], zlib.compress(text, 0)[2:-4],
                zlib.compress(text, 1)[2:-4], zlib.compress(text, 9)[2:-4]]
    w = max(map(len, streams))
    arr = np.zeros((len(streams), w), np.uint8)
    for i, s in enumerate(streams):
        arr[i, : len(s)] = np.frombuffer(s, np.uint8)
    x = torch.from_numpy(arr).cuda()
    lens = torch.tensor([len(s) for s in streams], dtype=torch.int32).cuda()
    res = {}
    for cap in (4096, 2000):
        out, st = dc.inflate_batch(x, lens, cap)
        oref, sref = dc.inflate_batch_plain(x, lens, cap)
        res[f"cap_{cap}_err"] = max(cs.max_err(out, oref),
                                    cs.max_err(st, sref))
        res[f"cap_{cap}_status"] = st.tolist()[-6:]
    print(json.dumps({"group": "garbage", **res}), flush=True)
    return res


def timing() -> None:
    n = 1 << 16
    data = cs.text_corpus(1024 * n, cs.SEED)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).reshape(
        1024, n).cuda()
    xl = torch.full((1024,), n, dtype=torch.int32).cuda()
    res = {}
    prev = dc.deflate_links(x, xl)
    res["links_ms"] = cs.cuda_ms(lambda: dc.deflate_links(x, xl), 3)
    tok, nt = dc.deflate_parse(x, xl, prev, 128)
    res["parse_128_ms"] = cs.cuda_ms(
        lambda: dc.deflate_parse(x, xl, prev, 128), 2)
    comp, clens = dc.deflate_emit(x, xl, tok, nt, 0)
    res["emit_ms"] = cs.cuda_ms(lambda: dc.deflate_emit(x, xl, tok, nt, 0),
                                3)
    res["ratio"] = int(clens.sum()) / len(data)
    res["stored_ms"] = cs.cuda_ms(
        lambda: dc.deflate_emit(x, xl, None, None, 2), 3)
    out, st = dc.inflate_batch(comp, clens, n)
    res["inflate_ms"] = cs.cuda_ms(lambda: dc.inflate_batch(comp, clens, n),
                                   3)
    res["round_trip"] = bool(torch.equal(out, x))
    tok, nt = dc.deflate_parse_greedy(x, xl, prev)
    res["parse_greedy_ms"] = cs.cuda_ms(
        lambda: dc.deflate_parse_greedy(x, xl, prev), 3)
    comp, clens = dc.deflate_emit_tuple(x, xl, tok, nt)
    res["emit_tuple_ms"] = cs.cuda_ms(
        lambda: dc.deflate_emit_tuple(x, xl, tok, nt), 3)
    res["xla_rule_ratio"] = int(clens.sum()) / len(data)
    print(json.dumps({"group": "timing", "card": cs.nvidia_smi(), **res}),
          flush=True)


def wide() -> None:
    """Phase 18's four launches (codecs.zlib_.compress and decompress: one
    8 MiB row of the smoke's corpus), each alone: the links (the route of
    that width), the greedy parse with its best kernel, the tuple tables
    with the emit and the inflate, CUDA-event ms and the peak device
    memory of each launch over what its inputs hold; then the links at
    the wide path's 64 x 128 KiB (the same corpus at 128 KiB blocks)."""
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)[: cs.ZLIB_BYTES]
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(
        1, -1).cuda()
    xl = torch.tensor([len(data)], dtype=torch.int32, device="cuda")
    res = {"rows": list(x.shape), "links_route": dc.links_route(x.shape[1])}

    def alone(name, fn, reps):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        res[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        res[f"{name}_ms"] = cs.cuda_ms(fn, reps)
        return out

    prev = alone("links", lambda: dc.deflate_links(x, xl), 3)
    tok, nt = alone("parse_greedy",
                    lambda: dc.deflate_parse_greedy(x, xl, prev), 2)
    comp, clens = alone("emit_tuple",
                        lambda: dc.deflate_emit_tuple(x, xl, tok, nt), 2)
    out, st = alone("inflate",
                    lambda: dc.inflate_batch(comp, clens, x.shape[1]), 2)
    res["ntok"] = int(nt[0])
    res["ratio"] = int(clens[0]) / len(data)
    res["round_trip"] = bool(torch.equal(out, x)) and int(st[0]) == len(data)
    res["encode_kernels_mb_s"] = len(data) / 1e3 / sum(
        res[f"{k}_ms"] for k in ("links", "parse_greedy", "emit_tuple"))
    w = x.view(-1, 1 << 17)
    wl = torch.full((w.shape[0],), 1 << 17, dtype=torch.int32,
                    device="cuda")
    res["wide_path_rows"] = list(w.shape)
    res["wide_path_links_ms"] = cs.cuda_ms(lambda: dc.deflate_links(w, wl),
                                           3)
    tok, nt = dc.deflate_parse(w, wl, dc.deflate_links(w, wl),
                               cs.DEFLATE_PATH_CHAIN)
    res["wide_path_emit_ms"] = cs.cuda_ms(
        lambda: dc.deflate_emit(w, wl, tok, nt, 0), 3)
    res["links_exact"] = bool(
        torch.equal(prev, dc.deflate_links_plain(x, xl))
        and torch.equal(dc.deflate_links(w, wl), dc.deflate_links_plain(w, wl)))
    print(json.dumps({"group": "wide", "card": cs.nvidia_smi(), **res}),
          flush=True)


def parts() -> None:
    """Device ms of each kernel that the greedy parse (with its best
    kernel) and the links past 64 KiB launch, from one traced call each
    (chip_smoke.traced): the parse at 1024 x 64 KiB of text, zero and
    random rows and on phase 18's 8 MiB row, the links at the wide path's
    64 x 128 KiB and on that row."""
    n = 1 << 16
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).reshape(
        -1, n).cuda()
    xl = torch.full((x.shape[0],), n, dtype=torch.int32).cuda()
    rng = np.random.default_rng(13)
    row = x.reshape(-1)[: cs.ZLIB_BYTES].view(1, -1)
    row_len = torch.tensor([row.shape[1]], dtype=torch.int32).cuda()
    wide = row.view(-1, 1 << 17)
    wide_len = torch.full((wide.shape[0],), 1 << 17, dtype=torch.int32).cuda()
    res = {}
    for name, rows, lens in (
            ("text", x, xl), ("zero", torch.zeros_like(x), xl),
            ("random", torch.from_numpy(rng.integers(
                0, 256, tuple(x.shape), np.uint8)).cuda(), xl),
            ("zlib_row", row, row_len)):
        prev = dc.deflate_links(rows, lens)
        tok, nt = dc.deflate_parse_greedy(rows, lens, prev)
        res[f"parse_{name}"] = cs.traced(
            lambda: dc.deflate_parse_greedy(rows, lens, prev))["top"]
        if name in ("text", "zlib_row"):
            dc.deflate_emit_tuple(rows, lens, tok, nt)
            res[f"emit_tuple_{name}"] = cs.traced(
                lambda: dc.deflate_emit_tuple(rows, lens, tok, nt))["top"]
    for name, rows, lens in (("wide", wide, wide_len),
                             ("zlib_row", row, row_len)):
        dc.deflate_links(rows, lens)
        res[f"links_{name}"] = cs.traced(
            lambda: dc.deflate_links(rows, lens))["top"]
    tok, nt = dc.deflate_parse(wide, wide_len, dc.deflate_links(
        wide, wide_len), cs.DEFLATE_PATH_CHAIN)
    dc.deflate_emit(wide, wide_len, tok, nt, 0)
    res["emit_wide"] = cs.traced(
        lambda: dc.deflate_emit(wide, wide_len, tok, nt, 0))["top"]
    print(json.dumps({"group": "parts", "card": cs.nvidia_smi(), **res}),
          flush=True)


def parse_entry(lib):
    """(call(blocks, lens, prev, max_chain) -> (tokens, ntok)) of a build's
    tpz_deflate_parse, whichever of its two signatures the source has."""
    fn = lib.tpz_deflate_parse
    vp, ci = ctypes.c_void_p, ctypes.c_int
    scratch = "void* best_at" in lib._source
    fn.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp] + (
        [vp, vp] if scratch else [vp])
    fn.restype = ci

    def call(x, xl, prev, mc):
        b, n = x.shape
        tok = torch.zeros((b, n), dtype=torch.int32, device="cuda")
        nt = torch.empty(b, dtype=torch.int32, device="cuda")
        extra = [torch.empty((b, n), dtype=torch.int32,
                             device="cuda").data_ptr()] if scratch else []
        err = fn(x.data_ptr(), xl.data_ptr(), prev.data_ptr(), b, n, mc,
                 tok.data_ptr(), nt.data_ptr(), *extra,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "tpz_deflate_parse")
        return tok, nt
    return call


def load_dir(path: str):
    """DIR's deflate_encode.cu built with the checkout's flags."""
    nvcc = _build.find_nvcc()
    src = os.path.join(path, "deflate_encode.cu")
    so = os.path.join(tempfile.mkdtemp(), "libdeflate_ab.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", so, src], check=True,
                   capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(so)
    lib._source = open(src).read()
    return lib


def ab(dirs: list) -> None:
    n = 1 << 16
    data = cs.text_corpus(1024 * n, cs.SEED)
    text = torch.frombuffer(bytearray(data), dtype=torch.uint8).reshape(
        1024, n).cuda()
    rng = np.random.default_rng(13)
    xl = torch.full((1024,), n, dtype=torch.int32).cuda()
    shapes = {"text": text, "zero": torch.zeros_like(text),
              "random": torch.from_numpy(rng.integers(
                  0, 256, (1024, n), np.uint8)).cuda()}
    mine = _build.load("deflate_encode")
    mine._source = open(_build.CSRC / "deflate_encode.cu").read()
    new = parse_entry(mine)
    for d in dirs:
        old = parse_entry(load_dir(d))
        for name, mc in (("text", 8), ("text", 128), ("zero", 128),
                         ("random", 128)):
            x = shapes[name]
            prev = dc.deflate_links(x, xl)
            a, b = old(x, xl, prev, mc), new(x, xl, prev, mc)
            same = all(torch.equal(u, v) for u, v in zip(a, b))
            t = [cs.cuda_ms(lambda: f(x, xl, prev, mc), 2)
                 for f in (old, new, new, old)]
            print(json.dumps({"group": "ab", "dir": d, "rows": name,
                              "max_chain": mc, "outputs_equal": same,
                              "old_ms": (t[0] + t[3]) / 2,
                              "new_ms": (t[1] + t[2]) / 2,
                              "turns_ms": t}), flush=True)


# csrc/deflate_encode.cu with its tables and emit on another route at rows
# of at most 64 KiB: "tiled", the tiled route at every width (launch_emit's
# size switch and tpz_deflate_emit_scratch's set so); "counted", the C++
# rule's histograms by tiles (deflate_hist_kernel, then its Counted<>
# tables instance) with the row emit
ROUTE_PATCHES = {
    "tiled": (("const bool wide = n > lz4s::STAGE_MAX;",
               "const bool wide = true;"),
              ("  if (n <= lz4s::STAGE_MAX) return rows;\n", "")),
    "counted": (("  if (Shared::TUPLE || wide) {", "  if (true) {"),)}

# the kernels the tables and emit launch, as name fragments for traced()
EMIT_PARTS = ("deflate_hist_kernel", "deflate_tables_kernel",
              "deflate_emit_kernel", "deflate_emit_sums_kernel",
              "deflate_emit_scan_kernel", "deflate_emit_tiles_kernel")


def route_build(route: str, path: str) -> subprocess.Popen:
    """Write the checkout's deflate_encode.cu patched to `route`
    (ROUTE_PATCHES) into path/route/, beside the header it includes, and
    start its nvcc (the checkout's flags) into path/route.so."""
    src = (_build.CSRC / "deflate_encode.cu").read_text()
    for old, new in ROUTE_PATCHES[route]:
        if src.count(old) != 1:
            raise SystemExit(f"deflate_encode.cu: {old!r} is not there once")
        src = src.replace(old, new)
    os.makedirs(f"{path}/{route}")
    with open(f"{path}/{route}/deflate_encode.cu", "w") as f:
        f.write(src)
    shutil.copy(_build.CSRC / "lz4_shared.cuh", f"{path}/{route}/")
    return subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", f"{path}/{route}.so",
         f"{path}/{route}/deflate_encode.cu"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def emit_entries(lib) -> dict:
    """{"std": emit, "tuple": emit} of a build: its tpz_deflate_emit in
    mode 0 and its tpz_deflate_emit_tuple, each called as deflate_coder's
    wrappers call them (the output zeroed, the scratch of the build's own
    tpz_deflate_emit_scratch) -> (comp, clens)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tpz_deflate_emit.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, ci, vp,
                                     vp, vp]
    lib.tpz_deflate_emit_tuple.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp,
                                           vp]
    lib.tpz_deflate_emit_scratch.argtypes = [ci, ci]
    lib.tpz_deflate_emit_scratch.restype = ctypes.c_longlong

    def call(order, x, xl, tok, nt):
        b, n = x.shape
        comp = torch.zeros((b, dc.encode_cap(n)), dtype=torch.uint8,
                           device="cuda")
        clens = torch.empty(b, dtype=torch.int32, device="cuda")
        scratch = torch.empty(lib.tpz_deflate_emit_scratch(b, n),
                              dtype=torch.uint8, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        tail = (comp.data_ptr(), comp.shape[1], clens.data_ptr(),
                scratch.data_ptr(), stream)
        if order == "std":
            err = lib.tpz_deflate_emit(x.data_ptr(), xl.data_ptr(),
                                       tok.data_ptr(), nt.data_ptr(), b, n,
                                       0, *tail)
        else:
            err = lib.tpz_deflate_emit_tuple(tok.data_ptr(), nt.data_ptr(),
                                             b, n, *tail)
        _build.check(err, f"tpz_deflate_emit ({order})")
        return comp, clens
    return {order: (lambda *a, o=order: call(o, *a))
            for order in ("std", "tuple")}


def routes() -> None:
    """The tables with the emit of both rules at 1024 x 64 KiB (text, zero
    and random rows; the C++ rule's tokens at max_chain 128, the device
    rule's from its greedy parse) on the checkout's routes ("row": the C++
    rule's tables counting their own histograms, the row emit) against
    ROUTE_PATCHES' builds of the same source: outputs held equal, timed in
    turns (row, tiled, counted, counted, tiled, row; each the mean of 3
    launches), and each build's device ms by kernel from one traced call."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {r: route_build(r, tmp) for r in ROUTE_PATCHES}
        _build.build("deflate_encode")
        for r, p in procs.items():
            if p.wait(timeout=900):
                raise SystemExit(f"nvcc failed on the {r} copy:\n"
                                 f"{p.stdout.read()}")
        libs = {"row": _build.load("deflate_encode"),
                **{r: ctypes.CDLL(f"{tmp}/{r}.so") for r in ROUTE_PATCHES}}
        entries = {r: emit_entries(lib) for r, lib in libs.items()}
        n = 1 << 16
        data = cs.text_corpus(1024 * n, cs.SEED)
        rng = np.random.default_rng(13)
        kinds = {"text": lambda: torch.frombuffer(
                     bytearray(data), dtype=torch.uint8).view(1024, n),
                 "zero": lambda: torch.zeros((1024, n), dtype=torch.uint8),
                 "random": lambda: torch.from_numpy(
                     rng.integers(0, 256, (1024, n), np.uint8))}
        xl = torch.full((1024,), n, dtype=torch.int32, device="cuda")
        order_turns = ("row", "tiled", "counted", "counted", "tiled", "row")
        for kind, make in kinds.items():
            x = make().cuda()
            prev = dc.deflate_links(x, xl)
            tokens = {"std": dc.deflate_parse(x, xl, prev, 128),
                      "tuple": dc.deflate_parse_greedy(x, xl, prev)}
            del prev
            for order, (tok, nt) in tokens.items():
                fns = {r: (lambda f=e[order]: f(x, xl, tok, nt))
                       for r, e in entries.items()}
                outs = {r: fn() for r, fn in fns.items()}
                same = {r: all(torch.equal(a, b) for a, b in
                               zip(outs[r], outs["row"])) for r in outs}
                del outs
                t = [cs.cuda_ms(fns[r], 3) for r in order_turns]
                ms = {r: sum(v for k, v in zip(order_turns, t) if k == r) / 2
                      for r in fns}
                parts = {r: cs.traced(fn, EMIT_PARTS)["expected_ms"]
                         for r, fn in fns.items()}
                print(json.dumps({
                    "group": "routes", "card": cs.nvidia_smi(), "rows": kind,
                    "order": order, "ntok": int(nt.sum()),
                    "outputs_equal": same, "ms": ms,
                    "ratio_to_row": {r: v / ms["row"] for r, v in ms.items()},
                    "turns": list(zip(order_turns, t)), "parts_ms": parts}),
                    flush=True)
            del x, tokens


def main() -> int:
    print(cs.nvidia_smi(), flush=True)
    if sys.argv[1:2] == ["--routes"]:
        routes()
        return 0
    ptxas()
    if sys.argv[1:2] == ["--wide"]:
        wide()
        parts()
        return 0
    if sys.argv[1:2] == ["--ab"]:
        ab(sys.argv[2:])
    for fn in (lambda: check(*rows(4096), "rows_4096"),
               lambda: check(*far_rows(), "far_rows"), tables, garbage,
               timing):
        try:
            fn()
        except Exception:
            traceback.print_exc()
    return 0


if __name__ == "__main__":
    sys.exit(main())
