"""xxHash32 over a batch of rows, and the stripe update of a streaming
state: the CUDA kernel's wrappers and their plain PyTorch versions.

tpuzip computes the LZ4 frame's checksums on the host: its C++
``tpz_xxh32`` and ``tpz_xxh32_stripes`` (csrc/tpuzip_host.cpp:74-127) or
its oracle (tpuzip/oracle/xxh32.py).  csrc/xxh32.cu replaces them:

  batch    each row's xxh32 at a seed: four lanes from the seed over its
           whole 16-byte stripes, v = rotl(v + w * P2, 13) * P1; below 16
           bytes seed + P5, else the lanes rotated and summed; then the
           length, the 4-byte and 1-byte tails and the avalanche.
  stripes  the four lane states of a streaming xxh32, updated in place
           over whole stripes (the tail and the digest stay with the
           caller, core.checksum.Xxh32Stream).

The plain versions carry the lanes as int64 masked to 32 bits (torch's
uint32 has no arithmetic on the CPU), every row's four lanes at once, one
stripe a step.  No PyTorch call computes xxh32.
"""

from __future__ import annotations

import ctypes

import torch

from tpuzip_torch.kernels import _build

P1 = 2654435761
P2 = 2246822519
P3 = 3266489917
P4 = 668265263
P5 = 374761393
M32 = 0xFFFFFFFF


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for u32 values in int64, in products below 2^49."""
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def _words(rows: torch.Tensor, at: int, count: int) -> torch.Tensor:
    """The little-endian u32 words at bytes at, at + 4, ... of each row, as
    int64 (B, count); rows are padded by the caller."""
    b = rows[:, at : at + 4 * count].to(torch.int64).reshape(-1, count, 4)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _lanes(rows: torch.Tensor, v: torch.Tensor,
           stripes: torch.Tensor) -> torch.Tensor:
    """v (B, 4) after each row's first stripes[r] stripes of rows."""
    steps = int(stripes.max()) if rows.shape[0] else 0
    if steps == 0:
        return v
    wp = _mul(_words(rows, 0, 4 * steps).reshape(-1, steps, 4), P2)
    for s in range(steps):
        nv = _mul(_rotl((v + wp[:, s]) & M32, 13), P1)
        v = torch.where((stripes > s)[:, None], nv, v)
    return v


def xxh32_batch_plain(rows: torch.Tensor, lens: torch.Tensor,
                      seed: int = 0) -> torch.Tensor:
    """Plain version of the batch kernel: rows (B, w) u8, lens (B,) (read
    as at most w) -> (B,) int64, each row's xxh32 (a u32)."""
    b, w = rows.shape
    dev = rows.device
    n = lens.to(torch.int64).clamp(0, w)
    rows = torch.nn.functional.pad(rows, (0, 16))
    seed &= M32
    v = torch.tensor([(seed + P1 + P2) & M32, (seed + P2) & M32, seed,
                      (seed - P1) & M32], dtype=torch.int64,
                     device=dev).repeat(b, 1)
    stripes = n // 16
    v = _lanes(rows, v, stripes)
    h = torch.where(n >= 16, (_rotl(v[:, 0], 1) + _rotl(v[:, 1], 7)
                              + _rotl(v[:, 2], 12) + _rotl(v[:, 3], 18))
                    & M32, (seed + P5) & M32)
    h = (h + n) & M32
    p = 16 * stripes
    rix = torch.arange(b, device=dev)
    for _ in range(3):   # the tail's words: fewer than 16 bytes
        live = p + 4 <= n
        at = p[:, None] + torch.arange(4, device=dev)
        by = rows[rix[:, None], at.clamp(max=rows.shape[1] - 1)].to(
            torch.int64)
        word = by[:, 0] | by[:, 1] << 8 | by[:, 2] << 16 | by[:, 3] << 24
        h = torch.where(live, _mul(_rotl((h + _mul(word, P3)) & M32, 17),
                                   P4), h)
        p = torch.where(live, p + 4, p)
    for _ in range(3):   # then its bytes: fewer than 4
        live = p < n
        by = rows[rix, p.clamp(max=rows.shape[1] - 1)].to(torch.int64)
        h = torch.where(live, _mul(_rotl((h + by * P5) & M32, 11), P1), h)
        p = torch.where(live, p + 1, p)
    h ^= h >> 15
    h = _mul(h, P2)
    h ^= h >> 13
    h = _mul(h, P3)
    h ^= h >> 16
    return h


def xxh32_stripes_plain(state: torch.Tensor, data: torch.Tensor,
                        nstripes: int) -> None:
    """Plain version of the stripe kernel: state (4,) i32 holding the four
    u32 lanes, updated in place over the first nstripes 16-byte stripes of
    data (1-D u8)."""
    v = (state.to(torch.int64) & M32)[None]
    v = _lanes(data[None, : 16 * nstripes], v,
               torch.tensor([nstripes], device=data.device))
    state.copy_(((v[0] + (1 << 31)) & M32) - (1 << 31))


def _lib(name: str):
    fn = getattr(_build.load("xxh32"), f"tpz_xxh32_{name}")
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = ([vp, vp, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_uint, vp, vp] if name == "batch"
                       else [vp, vp, ctypes.c_longlong, vp])
        fn.restype = ctypes.c_int
    return fn


def xxh32_batch(rows: torch.Tensor, lens: torch.Tensor,
                seed: int = 0) -> torch.Tensor:
    """xxh32 of every row: rows (B, w) u8 whose rows are contiguous (any
    row pitch), lens (B,) i32 (read as at most w) -> (B,) int64 of u32
    hashes.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/xxh32.cu on the current stream (no synchronisation)."""
    if rows.dtype != torch.uint8 or lens.dtype != torch.int32:
        raise TypeError("xxh32_batch takes u8 rows and i32 lengths")
    if rows.dim() != 2 or lens.shape != rows.shape[:1]:
        raise ValueError(f"shape mismatch: rows {tuple(rows.shape)}, "
                         f"lengths {tuple(lens.shape)}")
    if rows.device != lens.device:
        raise ValueError("rows and lengths must share a device")
    if rows.device.type == "cpu":
        return xxh32_batch_plain(rows, lens, seed)
    if rows.device.type != "cuda":
        raise ValueError(f"no xxh32 kernel for device {rows.device}")
    if rows.stride(1) != 1 or not lens.is_contiguous():
        raise ValueError("xxh32_batch takes rows of contiguous bytes")
    b = rows.shape[0]
    out = torch.empty(b, dtype=torch.int32, device=rows.device)
    if b == 0:
        return out.to(torch.int64)
    with torch.cuda.device(rows.device):
        err = _lib("batch")(rows.data_ptr(), lens.data_ptr(), b,
                            rows.stride(0), seed & M32, out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "xxh32_batch")
    xxh32_batch.launches += 1
    return out.to(torch.int64) & M32


def xxh32_stripes(state: torch.Tensor, data: torch.Tensor,
                  nstripes: int) -> None:
    """Update the streaming state (4,) i32 (the four u32 lanes) in place
    over the first nstripes 16-byte stripes of data (1-D u8, contiguous).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/xxh32.cu's stripe entry on the current stream (no
    synchronisation)."""
    if (state.dtype != torch.int32 or state.shape != (4,)
            or data.dtype != torch.uint8 or data.dim() != 1):
        raise TypeError("xxh32_stripes takes a (4,) i32 state and 1-D u8 "
                        "data")
    if not 0 <= 16 * nstripes <= data.numel():
        raise ValueError(f"{nstripes} stripes need {16 * nstripes} bytes, "
                         f"data holds {data.numel()}")
    if state.device != data.device:
        raise ValueError("state and data must share a device")
    if data.device.type == "cpu":
        return xxh32_stripes_plain(state, data, nstripes)
    if data.device.type != "cuda":
        raise ValueError(f"no xxh32 kernel for device {data.device}")
    if not (state.is_contiguous() and data.is_contiguous()):
        raise ValueError("xxh32_stripes takes contiguous tensors")
    if nstripes == 0:
        return None
    with torch.cuda.device(data.device):
        err = _lib("stripes")(state.data_ptr(), data.data_ptr(), nstripes,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(err, "xxh32_stripes")
    xxh32_stripes.launches += 1
    return None


xxh32_batch.launches = 0
xxh32_stripes.launches = 0
