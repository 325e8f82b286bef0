#!/usr/bin/env python3
"""The streams slice's kernels on one GPU, without the rest of the smoke:

    python3 tools/stream_kernels.py

Builds every source as chip_smoke.py's phase 2 does (registers and spills
by nvcc -Xptxas -v), stamps one xxh32 lane step by clock64
(tools/xxh32_step.cu: the dependent latency that n / 16 steps of a lane's
chain cannot beat), then runs chip_smoke.py's phase 19 (streams): the LZ4
frame and the streaming adapters through tpuzip_torch's entry points, the
new kernels and modes held exact against their plain versions and timed.
Prints the card, one JSON line a part; exits non-zero on any failure."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tpuzip_torch.kernels import _build  # noqa: E402

STEPS = 1 << 20


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def step_cycles() -> dict:
    """Cycles of one xxh32 lane step, from STEPS stamped steps."""
    with tempfile.TemporaryDirectory() as tmp:
        so = f"{tmp}/xxh32_step.so"
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(ROOT, "tools", "xxh32_step.cu")],
                       check=True, timeout=300)
        fn = ctypes.CDLL(so).tpz_xxh32_step
    vp = ctypes.c_void_p
    fn.argtypes = [vp, ctypes.c_int, vp, vp, vp]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(1)
    words = torch.from_numpy(rng.integers(0, 1 << 31, 4096).astype(
        np.int32)).cuda()
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = torch.zeros(32, dtype=torch.int32, device="cuda")
    runs = []
    for _ in range(3):
        _build.check(fn(words.data_ptr(), STEPS, cycles.data_ptr(),
                        out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream),
                     "xxh32_step")
        torch.cuda.synchronize()
        runs.append(int(cycles[0]) / STEPS)
    return {"steps": STEPS, "cycles_a_step": runs, "clocks": clocks()}


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_kernels: no GPU", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    cs.phase_build()
    print(json.dumps({"xxh32_step": step_cycles()}), flush=True)
    cs.phase_streams(smi)
    print(json.dumps({"clocks_after": clocks()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
