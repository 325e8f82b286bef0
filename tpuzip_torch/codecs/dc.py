"""Distance coding (the DC of bwtdc), batched over rows on the tensor's
device.

Port of tpuzip/codecs/dc.py.  Format: tpuzip.oracle.dc,
``[n u32][first[256] u32, == n if absent][LEB128 distances, one a run]``.

Encode is parallel: the run heads by a compare with the left neighbour,
the runs compacted by a scatter, the next head of the same symbol and the
first occurrences by one stable sort of the int64 key ``sym*(n+2)+start``
and a batched ``torch.searchsorted``, then the varint bytes and the
prefix-sum packer (core.bitio).

Decode parses the self-delimiting varints in parallel into a dense (B, T)
int32 table, walks the runs with the scheduler of kernels/dc_scan (one run
a step; the CUDA kernel on the card), and expands the runs to bytes with
one scatter and a running max (``run_fill``).
"""

from __future__ import annotations

import torch

from tpuzip_torch.core.bitio import pack_bytes_varlen
from tpuzip_torch.kernels import dc_scan

VARINT_MAX = 5  # u32 varints
HDR = 4 + 256 * 4


def encode_cap(n: int) -> int:
    return HDR + VARINT_MAX * n + 8


def varint_bytes(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v (..., ) non-negative < 2^32 -> (LEB128 bytes (..., VARINT_MAX) u8,
    lengths (...,) int64)."""
    v = v.to(torch.int64)
    k = torch.arange(VARINT_MAX, device=v.device)
    parts = (v[..., None] >> (7 * k)) & 0x7F
    lens = 1 + sum((v >= (1 << (7 * j))).to(torch.int64)
                   for j in range(1, VARINT_MAX))
    cont = k < (lens[..., None] - 1)
    return torch.where(cont, parts | 0x80, parts).to(torch.uint8), lens


def encode_batch(blocks: torch.Tensor, lengths: torch.Tensor):
    """(B, n) u8 blocks, (B,) lengths -> (comp (B, encode_cap(n)) u8, zero
    past each stream, comp_lens (B,) int32)."""
    b, n = blocks.shape
    dev = blocks.device
    cap = encode_cap(n)
    lens = lengths.to(torch.int64).clamp(0, n)
    idx = torch.arange(n, device=dev).expand(b, n)
    d = blocks.to(torch.int64)
    valid = idx < lens[:, None]
    head = valid.clone()
    head[:, 1:] &= d[:, 1:] != d[:, :-1]
    run_id = torch.cumsum(head, dim=1) - 1
    num_runs = head.sum(dim=1)
    r_valid = idx < num_runs[:, None]
    # compact the run heads: run k starts at run_start[:, k]
    run_start = torch.zeros((b, n + 1), dtype=torch.int64, device=dev)
    run_start.scatter_(1, torch.where(head, run_id, n), idx)
    run_start = run_start[:, :n]
    run_sym = torch.gather(d, 1, run_start)
    run_end = torch.cat([run_start[:, 1:], run_start.new_zeros((b, 1))], 1)
    run_end = torch.where(idx == num_runs[:, None] - 1, lens[:, None], run_end)
    # next head of the same symbol: runs sorted by (sym, start)
    span = n + 2
    key = torch.where(r_valid, run_sym * span + run_start, 257 * span)
    skey, perm = torch.sort(key, dim=1, stable=True)
    sym_sorted, start_sorted = skey // span, skey % span
    same = torch.zeros_like(r_valid)
    same[:, :-1] = sym_sorted[:, 1:] == sym_sorted[:, :-1]
    nxt_sorted = torch.full_like(start_sorted, -1)
    nxt_sorted[:, :-1] = torch.where(same[:, :-1], start_sorted[:, 1:], -1)
    next_head = torch.empty_like(nxt_sorted).scatter_(1, perm, nxt_sorted)
    # the first occurrence of a symbol heads its group of the sort
    syms = torch.arange(256, device=dev).expand(b, 256).contiguous()
    q = torch.searchsorted(sym_sorted, syms).clamp(max=max(n - 1, 0))
    if n:
        found = torch.gather(sym_sorted, 1, q) == syms
        first = torch.where(found, torch.gather(start_sorted, 1, q),
                            lens[:, None])
    else:
        first = lens[:, None].expand(b, 256)
    dists = torch.where(r_valid & (next_head >= 0),
                        next_head - (run_end - 1), 0)
    vb, vl = varint_bytes(dists)
    body, body_len = pack_bytes_varlen(vb, torch.where(r_valid, vl, 0),
                                       cap - HDR)
    hdr = torch.cat([lens[:, None], first], 1)
    hdr = (hdr[:, :, None] >> torch.arange(0, 32, 8, device=dev)) & 0xFF
    comp = torch.cat([hdr.reshape(b, HDR).to(torch.uint8), body], 1)
    return comp, (HDR + body_len).to(torch.int32)


def _le32(comp: torch.Tensor, at: int, count: int) -> torch.Tensor:
    """`count` u32 LE fields of every row from byte `at`, read into int32
    (a value >= 2^31 wraps negative, as tpuzip reads it)."""
    f = comp[:, at : at + 4 * count].to(torch.int64).reshape(
        comp.shape[0], count, 4)
    f = (f << torch.arange(0, 32, 8, device=comp.device)).sum(2)
    return dc_scan.wrap32(f).to(torch.int32)


def parse_varints(comp: torch.Tensor, comp_lens: torch.Tensor,
                  max_steps: int) -> torch.Tensor:
    """Parallel LEB128 parse of every row's body (bytes HDR .. comp_len):
    a varint starts at the body's head and after every terminator byte
    (high bit clear).  -> (B, max_steps) int32, the k-th varint of each
    row; 0 past its last varint (tpuzip's sort leaves other values there,
    which a finished walk never reads).  Values wrap to int32 as tpuzip's
    do."""
    b, cap = comp.shape
    dev = comp.device
    pos = torch.arange(cap, device=dev)
    in_body = (pos >= HDR) & (pos < comp_lens.to(torch.int64)[:, None])
    x = torch.where(in_body, comp.to(torch.int64), 0)
    term = (x < 0x80) & in_body
    start = in_body.clone()
    start[:, HDR + 1:] &= term[:, HDR:-1]
    val = torch.zeros((b, cap), dtype=torch.int64, device=dev)
    more = torch.ones((b, cap), dtype=torch.bool, device=dev)
    for k in range(VARINT_MAX):
        # byte k of the varint starting at each position (0 past the row)
        xk = torch.nn.functional.pad(x[:, k:], (0, k))
        val |= torch.where(more, (xk & 0x7F) << (7 * k), 0)
        more &= xk >= 0x80
    ordinal = torch.cumsum(start, dim=1) - 1
    slot = torch.where(start & (ordinal < max_steps), ordinal, max_steps)
    vals = torch.zeros((b, max_steps + 1), dtype=torch.int32, device=dev)
    vals.scatter_(1, slot, dc_scan.wrap32(val).to(torch.int32))
    return vals[:, :max_steps].contiguous()


def run_fill(starts: torch.Tensor, run_lens: torch.Tensor,
             syms: torch.Tensor, length: torch.Tensor,
             out_n: int) -> torch.Tensor:
    """Expand run triples (B, T) to bytes (B, out_n) u8, 0 past each
    length: the latest run that starts at or before a position holds it
    (``(run << 8) | sym`` scattered by max, then a running max; int64, so
    tpuzip's int32 switch at T = 2^23 is not needed)."""
    b, t = starts.shape
    dev = starts.device
    s = starts.to(torch.int64)
    keep = (run_lens > 0) & (s >= 0) & (s < out_n)
    packed = ((torch.arange(t, device=dev) << 8)[None, :]
              | syms.to(torch.int64))
    acc = torch.full((b, out_n + 1), -1, dtype=torch.int64, device=dev)
    acc.scatter_reduce_(1, torch.where(keep, s, out_n), packed, "amax")
    filled = torch.cummax(acc[:, :out_n], dim=1).values
    inside = torch.arange(out_n, device=dev)[None, :] < length[:, None]
    return torch.where(inside, filled & 0xFF, 0).to(torch.uint8)


def decode_inputs(comp: torch.Tensor, comp_lens: torch.Tensor, out_n: int):
    """The run walk's inputs from DC streams (B, cap) u8: (vals (B, T)
    int32, first (B, 256) int32, length (B,) int32), T bounded by the
    body bytes a row can hold (every run reads >= 1 varint byte)."""
    b, cap = comp.shape
    if cap < HDR:
        comp = torch.nn.functional.pad(comp, (0, HDR - cap))
    length = torch.clamp(_le32(comp, 0, 1)[:, 0], max=out_n)
    first = _le32(comp, 4, 256).contiguous()
    steps = max(0, min(comp.shape[1] - HDR, out_n))
    return parse_varints(comp, comp_lens, steps), first, length


def decode_batch(comp: torch.Tensor, comp_lens: torch.Tensor, out_n: int):
    """DC streams (B, cap) u8 and their lengths -> (out (B, out_n) u8,
    length (B,) int32, err (B,) int32: a bad distance or an unfinished
    walk).  The walk is dc_scan.dc_decode_lanes (the CUDA kernel for a CUDA
    tensor)."""
    vals, first, length = decode_inputs(comp, comp_lens, out_n)
    starts, run_lens, syms, err = dc_scan.dc_decode_lanes(vals, first,
                                                          length)
    return run_fill(starts, run_lens, syms, length, out_n), length, err
