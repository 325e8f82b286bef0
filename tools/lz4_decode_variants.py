#!/usr/bin/env python3
"""Time csrc/lz4_decode.cu against other builds of it at the lz4 path's
rows, on one GPU:

    python3 tools/lz4_decode_variants.py [--sass OUT] DIR [DIR ...]

Each DIR holds an lz4_decode.cu: a parent commit's, or a variant of the
checkout's.  Builds every source at once with its registers and spills
(nvcc -Xptxas -v), records the lz4 path's decode launch (the smoke's 64 MiB
corpus through tpuzip_torch.compress with no codec: 1024 rows of 64 KiB
blocks), and times each DIR's kernel against the checkout's in turns (DIR,
checkout, checkout, DIR; each the mean of 3 launches) on all 1024 rows, on
the first 8 and on the first alone, with whether its bytes and statuses
equal the checkout's.  --sass OUT writes each build's cuobjdump -sass to
OUT/NAME_lz4_decode.sass.  Prints one JSON line a row count, then one of
the whole."""

from __future__ import annotations

import ctypes
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
from tpuzip_torch.kernels import _build, lz4_coder  # noqa: E402


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("lz4_decode_variants: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sass = None
    if argv[:1] == ["--sass"]:
        sass, argv = argv[1], argv[2:]
    if not argv:
        raise SystemExit("lz4_decode_variants.py needs a directory")
    nvcc = _build.find_nvcc()
    srcs = {"new": str(_build.CSRC / "lz4_decode.cu")}
    srcs.update({os.path.basename(os.path.normpath(d)): f"{d}/lz4_decode.cu"
                 for d in argv})
    res = {"nvidia_smi": cs.nvidia_smi()}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {k: subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{tmp}/{k}.so", v], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for k, v in srcs.items()}
        res["ptxas"] = cs.ptxas_report(procs)
        libs = {k: ctypes.CDLL(f"{tmp}/{k}.so") for k in srcs}
        if sass:
            os.makedirs(sass, exist_ok=True)
            for k in srcs:
                with open(f"{sass}/{k}_lz4_decode.sass", "w") as f:
                    f.write(subprocess.run(
                        [nvcc.rsplit("nvcc", 1)[0] + "cuobjdump", "-sass",
                         f"{tmp}/{k}.so"], capture_output=True, text=True,
                        check=True).stdout)
        data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
        blob = tpuzip_torch.compress(data)
        with cs.recorded(lz4_coder, "lz4_decode_batch") as calls:
            if tpuzip_torch.decompress(blob) != data:
                raise AssertionError("the lz4 path did not round-trip")
        (args, kw, _), = calls
        for rows in (1024, 8, 1):
            cut = tuple(a[:rows].contiguous() if torch.is_tensor(a) else a
                        for a in args)
            runs, steps = cs.ab_launchers(libs, "lz4_decode", cut, kw)
            ref = runs["new"]()
            rec = {"sequences": steps}
            for k, run in runs.items():
                t = [cs.cuda_ms(runs[j], 3) for j in (k, "new", "new", k)]
                rec[k] = {"equal": all(torch.equal(a, b)
                                       for a, b in zip(run(), ref)),
                          "ms": (t[0] + t[3]) / 2,
                          "checkout_ms": (t[1] + t[2]) / 2}
            res[f"rows_{rows}"] = rec
            print(json.dumps({"rows": rows, **rec}), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
