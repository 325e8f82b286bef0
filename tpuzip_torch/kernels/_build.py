"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``tpuzip_torch/csrc/<name>.cu`` has a plain C interface.  nvcc
compiles it for Hopper (``sm_90a``) into
``tpuzip_torch/build/lib<name>-<hash>.so``, where the hash covers the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  Nothing is built when a module is imported.

A missing nvcc, a failed compile or a failed load raises RuntimeError with
the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME / CUDA_PATH, else torch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of tpuzip_torch are "
                       "built at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu builds to; the name hashes the source, the
    shared headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, float]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together.  Returns the seconds each build took (0 if cached)."""
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = find_nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, so in todo.items():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, so)
    failures = []
    for name, (proc, tmp, so) in procs.items():
        out, err = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {name}.cu (exit "
                            f"{proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, so)   # atomic: a concurrent load never sees half
    if failures:
        raise RuntimeError("\n".join(failures))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                raise RuntimeError(f"cannot load the {name} kernel: {e}") \
                    from e
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
