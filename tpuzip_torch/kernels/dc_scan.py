"""The DC run walk over a batch of streams: the CUDA kernel's wrapper and
its plain PyTorch version.

Port of tpuzip/kernels/dc_scan.py (``_dc_decode_kernel``).  Each of the B
rows is one stream; its state is the scheduler ``sched[256]``: the
position where each symbol's next run starts, INF when none is scheduled.
One run a step, for step t with distance d = vals[t]:

  hit     = sched == pos           (one symbol in a well-formed stream)
  nxt     = min(min of sched with the hits cleared, length)
  target  = nxt - 1 + d            (the run's end plus the distance)
  bad     = active & (no hit | d > 0 & (target >= length | target < nxt))
  sched   = hits -> target if d > 0 and not bad, else INF
  output  (pos, nxt - pos, sum of the hit symbols), 0 when inactive

where active = pos < length, then pos = nxt.  A walk that has not reached
its length after the last step is an error too.  Arithmetic is int32 with
two's-complement wrap, as on the TPU: a clobbered header field reads
negative, and the outputs of corrupt rows agree bit for bit as well.  The
layout is batch-major (B, T); the TPU kernel's is time-major (T, L).
"""

from __future__ import annotations

import ctypes

import torch

from tpuzip_torch.kernels import _build

INF = 0x7FFFFFFF


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 two's-complement wrap of each (still
    int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def dc_decode_lanes_plain(vals: torch.Tensor, first: torch.Tensor,
                          lengths: torch.Tensor):
    """Lane-vectorised replica of the TPU kernel's step.  vals (B, T),
    first (B, 256), lengths (B,) int32 -> (starts, run_lens, syms (B, T)
    int32, err (B,) int32)."""
    b, t = vals.shape
    dev = vals.device
    length = lengths.to(torch.int64)
    sched = first.to(torch.int64)
    sched = torch.where(sched < length[:, None], sched, INF)
    iota = torch.arange(256, device=dev)
    pos = torch.zeros(b, dtype=torch.int64, device=dev)
    err = torch.zeros(b, dtype=torch.bool, device=dev)
    outs = torch.zeros((3, b, t), dtype=torch.int32, device=dev)
    d_all = vals.to(torch.int64)
    for step in range(t):
        # every walk finished: the remaining steps output 0 and keep err
        if step % 256 == 0 and not bool((pos < length).any()):
            break
        d = d_all[:, step]
        active = pos < length
        hit = sched == pos[:, None]
        cleared = torch.where(hit, INF, sched)
        nxt = torch.minimum(cleared.min(dim=1).values, length)
        target = wrap32(nxt - 1 + d)
        bad = active & (~hit.any(dim=1) | ((d > 0) & ((target >= length)
                                                      | (target < nxt))))
        move = (d > 0) & ~bad
        resched = torch.where(hit & move[:, None], target[:, None], cleared)
        sym = (hit * iota).sum(dim=1)
        outs[:, :, step] = torch.where(
            active, torch.stack([pos, wrap32(nxt - pos), sym]), 0)
        sched = torch.where(active[:, None], resched, sched)
        pos = torch.where(active, nxt, pos)
        err |= bad
    err |= pos < length
    return outs[0], outs[1], outs[2], err.to(torch.int32)


def _lib():
    lib = _build.load("dc_decode")
    fn = lib.tpz_dc_decode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def dc_decode_lanes(vals: torch.Tensor, first: torch.Tensor,
                    lengths: torch.Tensor):
    """The DC run walk of every row: vals (B, T), first (B, 256) and
    lengths (B,) int32 -> (starts, run_lens, syms (B, T) int32, err (B,)
    int32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/dc_decode.cu on the current stream (no synchronisation)."""
    if (vals.dtype != torch.int32 or first.dtype != torch.int32
            or lengths.dtype != torch.int32):
        raise TypeError("dc_decode_lanes takes i32 vals, first and lengths")
    b, t = vals.shape
    if first.shape != (b, 256) or lengths.shape != (b,):
        raise ValueError(f"shape mismatch: vals {tuple(vals.shape)}, first "
                         f"{tuple(first.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if not (vals.device == first.device == lengths.device):
        raise ValueError("vals, first and lengths must share a device")
    if vals.device.type == "cpu":
        return dc_decode_lanes_plain(vals, first, lengths)
    if vals.device.type != "cuda":
        raise ValueError(f"no dc_decode kernel for device {vals.device}")
    if not (vals.is_contiguous() and first.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("dc_decode_lanes takes contiguous tensors")
    outs = torch.empty((3, b, t), dtype=torch.int32, device=vals.device)
    err = torch.empty(b, dtype=torch.int32, device=vals.device)
    if b == 0:
        return outs[0], outs[1], outs[2], err
    fn = _lib()
    with torch.cuda.device(vals.device):
        code = fn(vals.data_ptr(), first.data_ptr(), lengths.data_ptr(), b,
                  t, outs[0].data_ptr(), outs[1].data_ptr(),
                  outs[2].data_ptr(), err.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "dc_decode")
    dc_decode_lanes.launches += 1
    return outs[0], outs[1], outs[2], err


dc_decode_lanes.launches = 0
