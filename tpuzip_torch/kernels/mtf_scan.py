"""Move-to-front over a batch of streams: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of tpuzip/kernels/mtf_scan.py (``_mtf_kernel``) and the masked scan
of tpuzip/codecs/mtf.py.  Each of the B rows is one stream; its state is
the rank permutation ``rank_of[sym]`` (256 entries).  A step

  encode: r = rank_of[sym], emit r        decode: sym with rank_of[sym] == r
  then:   rank_of[k] += (rank_of[k] < r) for every k, rank_of[sym] = 0

runs on the first ``lengths[b]`` bytes of a row; the output is 0 from
there on, as the masked XLA scan writes it (the TPU kernel does not mask,
so only its valid prefix is comparable).  Any B >= 0 and N >= 0: the
TPU's multiple-of-256 rows and lane groups are not part of the function.
The CUDA kernel cuts each row into chunks that run side by side
(csrc/mtf.cu; tests/test_torch_mtf_chunks.py holds the decomposition);
the plain version runs the rows' steps in order.
"""

from __future__ import annotations

import ctypes

import torch

from tpuzip_torch.kernels import _build


def mtf_batch_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                    decode: bool = False) -> torch.Tensor:
    """Lane-vectorised replica of the step of tpuzip/codecs/mtf.py: blocks
    (B, N) u8, lengths (B,) -> (B, N) u8, 0 at and past each length."""
    b, n = blocks.shape
    dev = blocks.device
    lens = lengths.to(torch.int64).clamp(0, n)
    out = torch.zeros((b, n), dtype=torch.uint8, device=dev)
    rank_of = torch.arange(256, dtype=torch.int64, device=dev).repeat(b, 1)
    steps = int(lens.max()) if b else 0
    for t in range(steps):
        x = blocks[:, t].to(torch.int64)
        if decode:
            r = x
            sym = (rank_of == r[:, None]).to(torch.int8).argmax(dim=1)
        else:
            sym = x
            r = torch.gather(rank_of, 1, sym[:, None]).squeeze(1)
        new = rank_of + (rank_of < r[:, None])
        new.scatter_(1, sym[:, None], 0)
        active = lens > t
        rank_of = torch.where(active[:, None], new, rank_of)
        out[:, t] = torch.where(active, sym if decode else r, 0).to(
            torch.uint8)
    return out


def _lib():
    lib = _build.load("mtf")
    fn = lib.tpz_mtf_chunked
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, vp, vp, ci, vp]
        fn.restype = ci
        lib.tpz_mtf_chunk_bytes.restype = ci
    return fn, lib.tpz_mtf_chunk_bytes()


def mtf_batch(blocks: torch.Tensor, lengths: torch.Tensor,
              decode: bool = False) -> torch.Tensor:
    """MTF encode (or decode) of every row: blocks (B, N) u8, lengths (B,)
    i32 -> (B, N) u8, 0 at and past each length.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/mtf.cu's three passes on the current stream (no synchronisation),
    counted as one launch."""
    if blocks.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError("mtf_batch takes u8 blocks and i32 lengths")
    if blocks.dim() != 2 or lengths.shape != blocks.shape[:1]:
        raise ValueError(f"shape mismatch: blocks {tuple(blocks.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if blocks.device != lengths.device:
        raise ValueError("blocks and lengths must share a device")
    if blocks.device.type == "cpu":
        return mtf_batch_plain(blocks, lengths, decode)
    if blocks.device.type != "cuda":
        raise ValueError(f"no mtf kernel for device {blocks.device}")
    if not (blocks.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("mtf_batch takes contiguous tensors")
    b, n = blocks.shape
    out = torch.empty((b, n), dtype=torch.uint8, device=blocks.device)
    if b == 0 or n == 0:
        return out
    fn, chunk = _lib()
    # the kernel's record of each chunk: its end list or its symbols' order,
    # then the list or the ranks at its start
    scratch = torch.empty(b * -(-n // chunk) * 256, dtype=torch.uint8,
                          device=blocks.device)
    with torch.cuda.device(blocks.device):
        err = fn(blocks.data_ptr(), lengths.data_ptr(), b, n, out.data_ptr(),
                 scratch.data_ptr(), int(decode),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mtf")
    mtf_batch.launches += 1
    return out


mtf_batch.launches = 0
