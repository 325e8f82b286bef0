#!/usr/bin/env python3
"""Check and time csrc/lz4_links.cu (both lz4 encoders' links past their
shared routes) on one GPU, from a checkout's root:

    python3 tools/lz4_links_probe.py              # checks and times
    python3 tools/lz4_links_probe.py --variants [NAME ...]
                                                  # the sorted route's
                                                  # constants, patched
    python3 tools/lz4_links_probe.py --profiler   # does torch.profiler
                                                  # still trace?

The checks hold every route exact against its plain version on the card:
the sorted links at 0, 1, 16, 17, 20, 24 and 32 bits on rows of 5,000
and 2,045 bytes (some short, empty or of 13 bytes), chip_smoke's 128 KiB
far rows, 8 serving rows of text, of zeros and of top_bits_rows, and 8
rows of 128 KiB; the tiled links at 0, 4, 12 and 16 bits on the far rows
and the 128 KiB rows; lz4_dense's words from the links and its whole
encode at 20, 16 and 32 bits; deflate's tiled links (the same template
under its key); then the sorted links on the serving path's 1024 rows of
text, zeros, random bytes and top_bits_rows at 20 and 32 bits, exact and
timed, the tile step alone (16,384 rows of 4 KiB: no merge), the tiled
links and deflate's at 64 x 128 KiB, the words from the links, and the
sorted links' peak memory past their input.  --variants builds copies of
lz4_links.cu with one of VARIANTS' patches each (all of them by default:
SORT_GROUP at 2^22 and 2^23 positions, and the tile step's and the merge
rounds' CTAs an SM asked of the compiler) and times each against the
source as it is in turns, outputs equal, with each copy's registers.
--profiler traces one deflate links launch before and after each of:
building the port's sources (nvcc in subprocesses), loading each
library, launching the links; then, each in a fresh process, after
loading one library alone.  Prints one line a check or time, the card
first.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tpuzip_torch.kernels import (_build, deflate_coder,  # noqa: E402
                                  lz4_dense, lz4_links)


def checks() -> int:
    _build.build("lz4_links", "lz4_dense", "lz4_chain", "deflate_encode")
    bad = {}

    def chk(name, got, ref):
        e = cs.max_err(got, ref)
        print(name, e, flush=True)
        if e:
            bad[name] = e

    x, lens, _ = cs.serving_tensor()
    rng = np.random.default_rng(1)
    kinds = {"text": x, "zero": torch.zeros_like(x),
             "random": torch.from_numpy(rng.integers(
                 0, 256, tuple(x.shape), np.uint8)).cuda(),
             "top": torch.from_numpy(cs.top_bits_rows(*x.shape, 5)).cuda()}
    small = x[:64, :5000].contiguous()
    sl = torch.full((64,), 5000, dtype=torch.int32, device="cuda")
    sl[::3], sl[1], sl[2], sl[4] = 4000, 0, 13, 17
    odd = x[:64, :2045].contiguous()
    ol = torch.full((64,), 2045, dtype=torch.int32, device="cuda")
    far, flens = (torch.from_numpy(a).cuda() for a in cs.far_rows(9))
    wide = x.view(-1)[:8 << 20].view(64, 131072)
    wl = torch.full((64,), 131072, dtype=torch.int32, device="cuda")
    wl[5] = 100000
    eight = {"small": (small, sl), "odd": (odd, ol), "far": (far, flens),
             "text8": (x[:8].contiguous(), lens[:8].contiguous()),
             "top8": (kinds["top"][:8].contiguous(), lens[:8].contiguous()),
             "zero8": (kinds["zero"][:8].contiguous(),
                       lens[:8].contiguous())}
    w8 = (wide[:8].contiguous(), wl[:8].contiguous())
    for bits in (17, 20, 24, 32, 0, 1, 16):
        for name, (r, ln) in eight.items():
            chk(f"sorted_{name}_{bits}", lz4_links.lz4_links_sorted(
                r, ln, bits), lz4_links.lz4_links_plain(r, ln, bits))
    for bits in (0, 4, 12, 16):
        for name, (r, ln) in {"far": (far, flens), "wide8": w8}.items():
            chk(f"tiled_{name}_{bits}", lz4_links.lz4_links_tiled(
                r, ln, bits), lz4_links.lz4_links_plain(r, ln, bits))
    chk("sorted_wide8_20", lz4_links.lz4_links_sorted(*w8, 20),
        lz4_links.lz4_links_plain(*w8, 20))
    for hl, (r, ln) in ((20, eight["text8"]), (16, (far, flens)),
                        (32, (small, sl))):
        prev = lz4_links.lz4_links(r, ln, lz4_dense.table_bits(hl))
        chk(f"words_links_{hl}", lz4_dense.lz4_dense_words_links(
            r, ln, prev), lz4_dense.lz4_dense_words_plain(r, ln, hl))
        got = lz4_dense.lz4_dense_encode_batch(r, ln, hl)
        ref = lz4_dense.lz4_dense_words_parse_plain(
            r, ln, lz4_dense.lz4_dense_words_plain(r, ln, hl))
        chk(f"encode_{hl}", got[0], ref[0])
        chk(f"clens_{hl}", got[1], ref[1])
    for name, (r, ln) in {"far": (far, flens), "wide8": w8}.items():
        chk(f"deflate_tiled_{name}", deflate_coder.deflate_links_tiled(
            r, ln), deflate_coder.deflate_links_plain(r, ln))
    for k, r in kinds.items():
        for bits in (20, 32):
            chk(f"full_{k}_{bits}", lz4_links.lz4_links_sorted(r, lens, bits),
                lz4_links.lz4_links_plain(r, lens, bits))
            print("ms", k, bits, cs.cuda_ms(
                lambda: lz4_links.lz4_links_sorted(r, lens, bits), 3),
                flush=True)
    t4 = x.reshape(-1, 4096)
    l4 = torch.full((t4.shape[0],), 4096, dtype=torch.int32, device="cuda")
    print("ms tile step alone, text 20", cs.cuda_ms(
        lambda: lz4_links.lz4_links_sorted(t4, l4, 20), 3))
    z4 = torch.zeros_like(t4)
    print("ms tile step alone, zero 20", cs.cuda_ms(
        lambda: lz4_links.lz4_links_sorted(z4, l4, 20), 3))
    print("ms tiled 64 x 128 KiB, 16", cs.cuda_ms(
        lambda: lz4_links.lz4_links_tiled(wide, wl, 16), 3))
    print("ms deflate tiled 64 x 128 KiB", cs.cuda_ms(
        lambda: deflate_coder.deflate_links_tiled(wide, wl), 3))
    prev = lz4_links.lz4_links_sorted(x, lens, 20)
    print("ms words from the links, 20", cs.cuda_ms(
        lambda: lz4_dense.lz4_dense_words_links(x, lens, prev), 3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    lz4_links.lz4_links_sorted(x, lens, 20)
    torch.cuda.synchronize()
    print("peak past the input", torch.cuda.max_memory_allocated() - before)
    print("bad", bad, flush=True)
    return 1 if bad else 0


GROUP = "constexpr long long SORT_GROUP = 1ll << 24;"
TILE = "__global__ void __launch_bounds__(SORT_THREADS)"
MERGE = "__global__ void __launch_bounds__(MERGE_THREADS)"
# name: (text of lz4_shared.cuh, its replacement)
VARIANTS = {"group22": (GROUP, GROUP.replace("24", "22")),
            "group23": (GROUP, GROUP.replace("24", "23")),
            "tile3": (TILE, TILE.replace("THREADS)", "THREADS, 3)")),
            "tile4": (TILE, TILE.replace("THREADS)", "THREADS, 4)")),
            "merge8": (MERGE, MERGE.replace("MERGE_THREADS)",
                                            "MERGE_THREADS, 8)"))}


def variants(names: list) -> int:
    """Each patched copy of lz4_links.cu against the source as it is, in
    turns (base, variant, variant, base), outputs equal."""
    with tempfile.TemporaryDirectory() as tmp:
        return _variants(names, tmp)


def _variants(names: list, tmp: str) -> int:
    libs, procs = {}, {}
    src = (_build.CSRC / "lz4_shared.cuh").read_text()
    for name in ["base", *names]:
        d = os.path.join(tmp, name)
        os.makedirs(d)
        text = src
        if name != "base":
            old, new = VARIANTS[name]
            assert old in text, name
            text = text.replace(old, new)
        with open(os.path.join(d, "lz4_shared.cuh"), "w") as f:
            f.write(text)
        shutil.copy(_build.CSRC / "lz4_links.cu", d)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{d}/lib.so", f"{d}/lz4_links.cu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                            out + err)]
        spills = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", out + err))
        print(json.dumps({"variant": name, "registers": regs,
                          "spill_bytes": spills}), flush=True)
        libs[name] = ctypes.CDLL(f"{tmp}/{name}/lib.so")
    vp, ci = ctypes.c_void_p, ctypes.c_int

    def runner(lib, x, xl, bits):
        fn = lib.tpz_lz4_links_sorted
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
        size = lib.tpz_lz4_links_sorted_scratch
        size.argtypes = [ci, ci]
        size.restype = ctypes.c_longlong
        b, n = x.shape
        scratch = torch.empty(size(b, n), dtype=torch.uint8, device="cuda")

        def run():
            prev = torch.empty((b, n), dtype=torch.int32, device="cuda")
            _build.check(fn(x.data_ptr(), xl.data_ptr(), b, n, bits,
                            prev.data_ptr(), scratch.data_ptr(),
                            torch.cuda.current_stream().cuda_stream),
                         "tpz_lz4_links_sorted")
            return prev
        return run

    x, lens, _ = cs.serving_tensor()
    rng = np.random.default_rng(3)
    shapes = {"text": (x, lens), "ab": (torch.tensor(
        [97, 98], dtype=torch.uint8, device="cuda").repeat(
            x.numel() // 2).view(x.shape), lens),
        "random": (torch.from_numpy(rng.integers(0, 256, tuple(x.shape),
                                                 np.uint8)).cuda(), lens),
        "tiles_alone": (x.reshape(-1, 4096), torch.full(
            (x.numel() // 4096,), 4096, dtype=torch.int32, device="cuda")),
        "row8MiB": (x.view(1, -1)[:, :8 << 20].contiguous(), torch.tensor(
            [8 << 20], dtype=torch.int32, device="cuda"))}
    differ = 0
    for kind, (r, ln) in shapes.items():
        for bits in (20, 32):
            runs = {k: runner(lib, r, ln, bits) for k, lib in libs.items()}
            ref = runs["base"]()
            eq = {k: bool(torch.equal(f(), ref)) for k, f in runs.items()}
            differ += not all(eq.values())
            times = {}
            for k in names:
                t = [cs.cuda_ms(runs[j], 3) for j in ("base", k, k, "base")]
                times[k] = [(t[1] + t[2]) / 2, (t[0] + t[3]) / 2]
            print(json.dumps({"kind": kind, "bits": bits, "equal": eq,
                              "ms_variant_base": times}), flush=True)
    return 1 if differ else 0


def _probe(tag: str, x, xl) -> None:
    tr = cs.traced(lambda: deflate_coder.deflate_links(x, xl),
                   ("deflate_links_shared_kernel",))
    print(tag, "missing" if tr["missing"] else "traced", flush=True)


def profiler_child(name: str) -> int:
    """A fresh process: a trace, the library `name` loaded, a trace."""
    x = torch.randint(0, 256, (128, 2048), dtype=torch.uint8, device="cuda")
    xl = torch.full((128,), 2048, dtype=torch.int32, device="cuda")
    _probe(f"{name}: before", x, xl)
    ctypes.CDLL(str(_build.library_path(name)))
    _probe(f"{name}: after", x, xl)
    return 0


def profiler() -> int:
    x = torch.randint(0, 256, (128, 2048), dtype=torch.uint8, device="cuda")
    xl = torch.full((128,), 2048, dtype=torch.int32, device="cuda")
    _probe("start", x, xl)
    names = ("lz4_links", "lz4_dense", "lz4_chain", "lz4p", "rle",
             "deflate_encode")
    _build.build(*names)
    _probe("after nvcc", x, xl)
    lz4_links._lib("sorted")
    _probe("after loading lz4_links", x, xl)
    lz4_links.lz4_links_sorted(x, xl, 20)
    torch.cuda.synchronize()
    _probe("after the sorted links", x, xl)
    for name in names[:-1]:
        out = subprocess.run([sys.executable, __file__, "--profiler-child",
                              name], capture_output=True, text=True,
                             timeout=300)
        print(out.stdout.strip(), out.returncode, flush=True)
    return 0


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("lz4_links_probe: no GPU", file=sys.stderr)
        return 1
    if argv[:1] == ["--profiler-child"]:
        return profiler_child(argv[1])
    print(cs.nvidia_smi(), flush=True)
    if argv[:1] == ["--variants"]:
        return variants(argv[1:] or list(VARIANTS))
    if argv[:1] == ["--profiler"]:
        return profiler()
    return checks()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
