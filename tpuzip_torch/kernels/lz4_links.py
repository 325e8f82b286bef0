"""The links of tpuzip's two lz4 encoders past their shared routes: the
CUDA kernels' wrappers and their plain PyTorch version.

Both lz4 encoders of the port start from the same function of a row,
its links:

  links  prev[p] for every position p < length - 12: the last q < p whose
         4 bytes hash as p's, h = (seq * 2654435761 mod 2^32) >> (32 -
         bits), h = 0 at every position for bits 0; -1 where there is none
         and from length - 12 on.

kernels/lz4_chain.py's chain is prev itself (tpuzip's C++
``tpz_lz4_compress_chained``, bits the config's hash_log clamped to 4..24);
kernels/lz4_dense.py's candidates are prev filtered (tpuzip's XLA
``_candidates``, bits 0..32).  Each encoder has its own kernel for rows of
at most STAGE_MAX bytes at hashes of at most SHARED_MAX_LOG bits (a direct
table of u16 slots in shared memory: the "shared" route).  The rest take
csrc/lz4_links.cu, by shape alone (`links_route`):

  tiled   rows past STAGE_MAX bytes at at most SHARED_MAX_LOG bits: tiles
          of LINK_TILE positions, each linked as a row of the shared
          route, then a carry across the tiles (lz4_links_tiled).
  sorted  hashes of more than SHARED_MAX_LOG bits, at any width: a tile of
          SORT_TILE positions sorted by (hash, position) in shared memory,
          then its distinct hashes merged across the row's tiles
          (lz4_links_sorted).

The plain version is XLA's construction: one stable sort of each row's
hashes, a position's link the one before it where the hash is the same.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpuzip_torch.kernels import _build
from tpuzip_torch.kernels.lz4_coder import MF_LIMIT, HASH_MUL, _check_pair, \
    _mul32

# lz4_shared.cuh's: the shared routes take rows of at most STAGE_MAX bytes
# and u16 direct tables of at most SHARED_MAX_LOG bits; the tiled route
# tiles of LINK_TILE positions, the sorted route tiles of SORT_TILE
STAGE_MAX = 1 << 16
SHARED_MAX_LOG = 16
LINK_TILE = 1 << 15
SORT_TILE = 1 << 12


def links_route(bits: int, n: int) -> str:
    """The links' route for rows of n bytes at a hash of `bits` bits (0..32):
    "shared" (the encoder's own kernel), "tiled" or "sorted"."""
    if bits > SHARED_MAX_LOG:
        return "sorted"
    return "shared" if n <= STAGE_MAX else "tiled"


def hashes(blocks: torch.Tensor, bits: int):
    """(seq, h) of every position: its 4 bytes as a u32 (bytes past the
    row read 0) and their hash at `bits` bits (0: h is 0), both int64."""
    n = blocks.shape[1]
    src = F.pad(blocks, (0, 3)).to(torch.int64)
    seq = (src[:, :n] | (src[:, 1:n + 1] << 8) | (src[:, 2:n + 2] << 16)
           | (src[:, 3:n + 3] << 24))
    if bits == 0:
        return seq, torch.zeros_like(seq)
    return seq, _mul32(seq, HASH_MUL) >> (32 - bits)


def lz4_links_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Plain version of the links: blocks (B, n) u8, lengths (B,), bits
    0..32 -> prev (B, n) i32, as the module note says."""
    b, n = blocks.shape
    _, h = hashes(blocks, bits)
    order = torch.sort(h, dim=1, stable=True).indices  # positions ascending
    hs = h.gather(1, order)                              # within a hash
    earlier = F.pad(order[:, :-1], (1, 0), value=-1)
    same = F.pad(hs[:, 1:] == hs[:, :-1], (1, 0), value=False)
    prev = torch.empty_like(order).scatter_(1, order,
                                            torch.where(same, earlier, -1))
    idx = torch.arange(n, device=blocks.device)[None, :]
    limit = lengths.to(torch.int64).clamp(0, n)[:, None] - MF_LIMIT
    return torch.where(idx < limit, prev, -1).to(torch.int32)


def _lib(name: str):
    """The typed C entry point tpz_lz4_links_<name> of csrc/lz4_links.cu."""
    fn = getattr(_build.load("lz4_links"), f"tpz_lz4_links_{name}")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"tiled": [vp, vp, ci, ci, ci, vp, vp, vp],
                       "sorted": [vp, vp, ci, ci, ci, vp, vp, vp],
                       "tiled_scratch": [ci, ci, ci],
                       "sorted_scratch": [ci, ci]}[name]
        fn.restype = (ctypes.c_longlong if name.endswith("scratch")
                      else ci)
    return fn


def _launch(route: str, blocks: torch.Tensor, lengths: torch.Tensor,
            bits: int) -> torch.Tensor:
    """prev from csrc/lz4_links.cu's `route` on the current stream; its
    scratch is freed when it returns (the caching allocator keeps it in
    stream order)."""
    b, n = blocks.shape
    dev = blocks.device
    prev = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return prev
    with torch.cuda.device(dev):
        size = (_lib("tiled_scratch")(b, n, bits) if route == "tiled"
                else _lib("sorted_scratch")(b, n))
        scratch = torch.empty(size, dtype=torch.uint8, device=dev)
        err = _lib(route)(blocks.data_ptr(), lengths.data_ptr(), b, n, bits,
                          prev.data_ptr(), scratch.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"lz4_links_{route}")
    return prev


def _check_bits(bits: int, most: int) -> None:
    if not 0 <= bits <= most:
        raise ValueError(f"bits must be in 0..{most}, not {bits}")


def lz4_links_tiled(blocks: torch.Tensor, lengths: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """The links on the tiled route, rows of any width at bits 0..16:
    blocks (B, n) u8, lengths (B,) i32 -> prev (B, n) i32.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4_links.cu's tiled links and carry kernels on the current
    stream (no synchronisation); one launch is counted."""
    _check_pair("lz4_links_tiled", blocks, lengths)
    _check_bits(bits, SHARED_MAX_LOG)
    if blocks.device.type == "cpu":
        return lz4_links_plain(blocks, lengths, bits)
    prev = _launch("tiled", blocks, lengths, bits)
    lz4_links_tiled.launches += 1
    return prev


def lz4_links_sorted(blocks: torch.Tensor, lengths: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """The links on the sorted route, rows of any width at bits 0..32:
    blocks (B, n) u8, lengths (B,) i32 -> prev (B, n) i32.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4_links.cu's tile sort and merge rounds on the current stream
    (no synchronisation); one launch is counted."""
    _check_pair("lz4_links_sorted", blocks, lengths)
    _check_bits(bits, 32)
    if blocks.device.type == "cpu":
        return lz4_links_plain(blocks, lengths, bits)
    prev = _launch("sorted", blocks, lengths, bits)
    lz4_links_sorted.launches += 1
    return prev


def lz4_links(blocks: torch.Tensor, lengths: torch.Tensor,
              bits: int) -> torch.Tensor:
    """prev (B, n) i32 past the shared route: lz4_links_tiled or
    lz4_links_sorted, as links_route(bits, n) says (which count their own
    launches); a shape of the shared route raises ValueError."""
    _check_pair("lz4_links", blocks, lengths)
    route = links_route(bits, blocks.shape[1])
    if route == "shared":
        raise ValueError(f"rows of {blocks.shape[1]} bytes at {bits} bits "
                         "take the encoder's shared route")
    return (lz4_links_tiled if route == "tiled"
            else lz4_links_sorted)(blocks, lengths, bits)


lz4_links_tiled.launches = 0
lz4_links_sorted.launches = 0
