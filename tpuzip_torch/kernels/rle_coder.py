"""Run-length encode and decode over a batch of blocks: the CUDA kernels'
wrappers and their plain PyTorch versions.

tpuzip has no Pallas kernel for rle.  Off the TPU its runner encodes and
decodes codec "rle" with the C++ loops ``tpz_rle_encode`` and
``tpz_rle_decode`` (csrc/tpuzip_host.cpp:1795, :1822); the port may
not call them, so the two kernels of csrc/rle.cu replace them, 256 threads
a block, and the functions here are theirs:

  encode  the bytes of tpuzip.oracle.rle.encode(block): a byte as it is, a
          run of two or more as the byte twice and a count of the rest,
          chained by 255 without bound.
  encode, segments
          the bytes of tpuzip's XLA encoder (tpuzip/codecs/rle.py:30
          ``encode``, which compress_from_device runs): each run cut into
          segments of at most 256 bytes, one of L >= 2 bytes written as
          the byte twice and L - 2, one of 1 byte as the byte (a run of
          257 is b b 254 b).  rle.cu's encoder under a template flag.
  decode  tpz_rle_decode's status: the decoded length, or -1 for a count
          past the stream or output past out_cap.  Two equal bytes call
          for a count; the pair re-arms only after its count bytes.  The
          output row holds the decoded bytes and 0 after them; a row with
          status -1 is all 0.

The plain versions run every row at once: the encoder finds the runs with
a compare and a cumulative sum and writes each output byte from its run;
the decoder takes one pair (a literal stretch and a fill) a row a step,
the next pair and the end of a count looked up in suffix minima, and
writes each output byte from its stretch or fill.
"""

from __future__ import annotations

import ctypes

import torch

from tpuzip_torch.codecs.rle import encode_cap
from tpuzip_torch.kernels import _build
from tpuzip_torch.kernels.lz4_coder import _check_pair, _gather, _read

DECODE_TILE = 4096    # stream bytes a tile of the decoder kernel
DECODE_STAGE = 8192   # a tile's output staged in shared memory, at most
SEGMENT = 256         # bytes of a run's segment in tpuzip's XLA form


def _locate(start: torch.Tensor, cap: int):
    """For every output byte p < cap of each row: the index of the piece
    that holds it (the last one starting at or before p) and p's offset in
    it.  `start` (B, S) is nondecreasing along each row."""
    b = start.shape[0]
    p = torch.arange(cap, device=start.device).expand(b, cap).contiguous()
    k = (torch.searchsorted(start, p, right=True) - 1).clamp(min=0)
    return p, k, p - start.gather(1, k)


def rle_encode_batch_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                           segments: bool = False):
    """Plain version of the encoder: blocks (B, n) u8, lengths (B,) ->
    (comp (B, 2n + 8) u8, zero past each stream, clens (B,) i32); with
    segments, tpuzip's XLA form."""
    b, n = blocks.shape
    dev = blocks.device
    cap = encode_cap(n)
    if n == 0:
        return (torch.zeros((b, cap), dtype=torch.uint8, device=dev),
                torch.zeros(b, dtype=torch.int32, device=dev))
    lens = lengths.to(torch.int64).clamp(0, n)
    x = blocks.to(torch.int64)
    col = torch.arange(n, device=dev)[None, :]
    valid = col < lens[:, None]
    prev = torch.nn.functional.pad(x, (1, 0), value=-1)[:, :n]
    head = valid & (x != prev)
    run = head.cumsum(1) - 1                   # each byte's run, per row
    trash = torch.full_like(run, n)            # column n collects the rest
    run_len = torch.zeros((b, n + 1), dtype=torch.int64, device=dev)
    run_len.scatter_add_(1, torch.where(valid, run, trash),
                         valid.to(torch.int64))
    run_val = torch.zeros_like(run_len)
    run_val.scatter_(1, torch.where(head, run, trash), x)
    run_len, run_val = run_len[:, :n], run_val[:, :n]
    extra = (run_len - 2).clamp(min=0)
    if segments:
        # 3 bytes a segment of 256, then 3 for a last one of 2..255 bytes,
        # 1 for a last one of 1
        rest = run_len % SEGMENT
        size = 3 * (run_len // SEGMENT) + torch.where(rest > 1, 3, rest)
    else:
        size = torch.where(run_len > 1, 3 + extra // 255, run_len)
    ends = size.cumsum(1)
    total = ends[:, -1]
    p, k, q = _locate(ends - size, cap)
    R, V, E = run_len.gather(1, k), run_val.gather(1, k), extra.gather(1, k)
    if segments:
        # byte q of a run: segment q // 3 of L bytes gives b b (L - 2)
        seg = (R - SEGMENT * (q // 3)).clamp(max=SEGMENT)
        val = torch.where(q % 3 < 2, V, seg - 2)
    else:
        # a run of R > 1: the byte twice, E // 255 bytes of 255, E % 255
        val = torch.where((R == 1) | (q < 2), V,
                          torch.where(q < 2 + E // 255, 255, E % 255))
    val = torch.where(p < total[:, None], val, 0)
    return val.to(torch.uint8), total.to(torch.int32)


def _suffix_min(hit: torch.Tensor, big: int) -> torch.Tensor:
    """For each column j: the least column >= j where `hit`, else big."""
    col = torch.arange(hit.shape[1], device=hit.device)
    at = torch.where(hit, col, big)
    return at.flip(1).cummin(1).values.flip(1)


def rle_decode_batch_plain(comp: torch.Tensor, clens: torch.Tensor,
                           out_cap: int):
    """Plain version of the decoder: comp (B, w) u8, clens (B,) (read as at
    most w) -> (out (B, out_cap) u8, status (B,) i64)."""
    b, w = comp.shape
    dev = comp.device
    n = clens.to(torch.int64).clamp(0, w)
    x = comp.to(torch.int64)
    big = w + 1
    col = torch.arange(w + 1, device=dev)[None, :]
    xp = torch.nn.functional.pad(x, (0, 2), value=-1)
    # the first pair at or after j (its second byte inside the stream), and
    # the first byte at or after j that ends a count (not 255)
    pair = _suffix_min((xp[:, :w + 1] == xp[:, 1:w + 2])
                       & (col + 1 < n[:, None]), big)
    ends = _suffix_min((xp[:, :w + 1] != 255) & (col < n[:, None]), big)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    i, o, status = zero.clone(), zero.clone(), zero.clone()
    running = n > 0
    pieces = []        # per step: (out start, length, source or -1, byte)

    def fail(rows):
        nonlocal running
        status.masked_fill_(rows, -1)
        running = running & ~rows

    while bool(running.any()):
        k = _read(pair, i)
        tail = running & (k >= big)
        # no pair left: the rest of the stream is literals, and the end
        lit = torch.where(tail, n - i, k + 2 - i)
        fail(running & (o + lit > out_cap))
        lit = torch.where(running, lit, 0)
        pieces.append((o, lit, i, zero))
        o = o + lit
        status = torch.where(running & tail, o, status)
        running = running & ~tail
        i = torch.where(running, k + 2, i)
        e = _read(ends, i)
        fail(running & (e >= big))
        extra = 255 * (e - i) + _read(x, e)
        fail(running & (o + extra > out_cap))
        extra = torch.where(running, extra, 0)
        pieces.append((o, extra, torch.full_like(i, -1), _read(x, k)))
        o = o + extra
        i = torch.where(running, e + 1, i)
    out = torch.zeros((b, out_cap), dtype=torch.uint8, device=dev)
    if not pieces or out_cap == 0:
        return out, status
    start, _, src, byte = (torch.stack(c, dim=1) for c in zip(*pieces))
    p, k, q = _locate(start, out_cap)
    s = src.gather(1, k)
    val = torch.where(s >= 0, _gather(x, s + q), byte.gather(1, k))
    out = torch.where(p < status[:, None], val, 0).to(torch.uint8)
    return out, status


def _lib(name: str):
    """The typed C entry point tpz_<name> of csrc/rle.cu."""
    fn = getattr(_build.load("rle"), f"tpz_{name}")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp]
        fn.restype = ci
    return fn


def rle_encode_batch(blocks: torch.Tensor, lengths: torch.Tensor):
    """rle encode of every row: blocks (B, n) u8, lengths (B,) i32 ->
    (comp (B, 2n + 8) u8, zero past each stream, clens (B,) i32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/rle.cu's encoder on the current stream (no synchronisation)."""
    _check_pair("rle_encode_batch", blocks, lengths)
    if blocks.device.type == "cpu":
        return rle_encode_batch_plain(blocks, lengths)
    return _encode(blocks, lengths, "rle_encode", rle_encode_batch)


def _encode(blocks, lengths, name: str, wrapper):
    """Launch tpz_<name> of csrc/rle.cu on CUDA rows and count it on
    `wrapper`."""
    b, n = blocks.shape
    cap = encode_cap(n)
    comp = torch.zeros((b, cap), dtype=torch.uint8, device=blocks.device)
    clens = torch.empty(b, dtype=torch.int32, device=blocks.device)
    if b == 0:
        return comp, clens
    fn = _lib(name)
    with torch.cuda.device(blocks.device):
        err = fn(blocks.data_ptr(), lengths.data_ptr(), b, n,
                 comp.data_ptr(), cap, clens.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    wrapper.launches += 1
    return comp, clens


def rle_encode_segments_batch_plain(blocks: torch.Tensor,
                                    lengths: torch.Tensor):
    """Plain version of the segment mode: rle_encode_batch_plain with
    segments."""
    return rle_encode_batch_plain(blocks, lengths, segments=True)


def rle_encode_segments_batch(blocks: torch.Tensor, lengths: torch.Tensor):
    """rle encode of every row in tpuzip's XLA form (runs cut into segments
    of at most 256 bytes): blocks (B, n) u8, lengths (B,) i32 -> (comp
    (B, 2n + 8) u8, zero past each stream, clens (B,) i32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/rle.cu's encoder in its segment mode on the current stream (no
    synchronisation)."""
    _check_pair("rle_encode_segments_batch", blocks, lengths)
    if blocks.device.type == "cpu":
        return rle_encode_segments_batch_plain(blocks, lengths)
    return _encode(blocks, lengths, "rle_encode_seg",
                   rle_encode_segments_batch)


def rle_decode_batch(comp: torch.Tensor, clens: torch.Tensor, out_cap: int):
    """rle decode of every row: comp (B, w) u8, clens (B,) i32 (read as at
    most w) -> (out (B, out_cap) u8, status (B,) i64), as the module note
    says.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/rle.cu's decoder on the current stream (no synchronisation)."""
    _check_pair("rle_decode_batch", comp, clens)
    if comp.device.type == "cpu":
        return rle_decode_batch_plain(comp, clens, out_cap)
    b, w = comp.shape
    out = torch.empty((b, out_cap), dtype=torch.uint8, device=comp.device)
    status = torch.empty(b, dtype=torch.int64, device=comp.device)
    if b == 0:
        return out, status
    fn = _lib("rle_decode")
    with torch.cuda.device(comp.device):
        err = fn(comp.data_ptr(), clens.data_ptr(), b, w, out.data_ptr(),
                 out_cap, status.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rle_decode")
    rle_decode_batch.launches += 1
    return out, status


rle_encode_batch.launches = 0
rle_encode_segments_batch.launches = 0
rle_decode_batch.launches = 0
