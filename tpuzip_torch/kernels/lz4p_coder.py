"""lz4p encode and decode over a batch of blocks (codecs/lz4p.py's format):
the CUDA kernels' wrappers and their plain PyTorch versions.

lz4p keeps LZ4's parse and changes only its serialisation, so the port
encodes a block with one of its LZ4 encoders and turns the LZ4 stream into
the columns: csrc/lz4p.cu's pack kernel.  Off the TPU tpuzip encodes and
decodes lz4p with its C++ coder (``tpz_lz4p_encode`` and
``tpz_lz4p_decode``, csrc/tpuzip_host.cpp:333, :409), on the device
with XLA (tpuzip/codecs/lz4p.py:50 ``encode``, :156 ``decode``); csrc/
lz4p.cu replaces both, and the functions here are its kernels':

  pack    LZ4 block streams (B, w) with their lengths -> lz4p rows of
          the same sequences and their lengths.  With split (the C++
          rule) a literal run or match over 65535 bytes is cut into
          pieces of 65535 (literal pieces with mlen 0 and offset 0, then
          the run's rest with the match's first piece, then the match's
          pieces with no literals and its offset); without it (the XLA
          rule) a row whose run passes 65535 gets length -1, since
          tpuzip's u16 columns would lose it (fault 7); so does a stream
          that none of the port's encoders writes (literals past its end,
          or columns past encode_cap(n)).
  decode  tpz_lz4p_decode's status: 0 for an empty stream; -1 for a
          stream under 8 bytes, an orig_len past out_cap, columns past
          the stream, literals past the stream or past orig_len, a match
          with offset 0 or past the bytes decoded so far or past orig_len,
          or sequences that do not add up to orig_len; else orig_len.
          Bytes after the literals are allowed.  The output row holds the
          decoded bytes and 0 after them; a row with status -1 is all 0.

The plain versions run every row at once: pack parses one LZ4 sequence a
row a step, then computes every output byte from its column entry or
literal; decode takes each sequence's output offset and literal source
from prefix sums over the columns, and resolves every match byte to a
literal by pointer doubling (byte k of a match at o with offset off is
byte o - off + k % off, always before o), as lz4_coder's decoder does.
"""

from __future__ import annotations

import ctypes

import torch

from tpuzip_torch.codecs.lz4p import HDR, XLA_MAX_BLOCK, encode_cap
from tpuzip_torch.kernels import _build, lz4_coder, lz4_dense
from tpuzip_torch.kernels.lz4_coder import (MIN_MATCH, _check_pair,
                                            _gather, _read)
from tpuzip_torch.kernels.lz4_dense import HASH_LOG as XLA_HASH_LOG

U16 = 0xFFFF


def _lz4_sequences(comp: torch.Tensor, clens: torch.Tensor):
    """Each row's LZ4 sequences, one a step: (literal source in the
    stream, literal length, match length, offset, valid), each (B, T);
    the last valid one of a row is its last literals (match length 0).
    A byte past a stream reads as 0, and a length extension ends there,
    as in the kernel (the port's encoders' streams never reach it)."""
    b, w = comp.shape
    src = comp.to(torch.int64)
    n = clens.to(torch.int64).clamp(0, w)
    i = torch.zeros(b, dtype=torch.int64, device=comp.device)
    running = n > 0
    steps = []

    def at(k):
        return torch.where(k < n, _read(src, k), 0)

    def extend(length, rows):
        """Add a length's extension bytes (rows whose nibble was 15)."""
        nonlocal i
        more = rows.clone()
        while bool(more.any()):
            byte = at(i)
            length = torch.where(more, length + byte, length)
            i = torch.where(more, i + 1, i)
            more &= (byte == 255) & (i < n)
        return length

    while bool(running.any()):
        token = at(i)
        i = torch.where(running, i + 1, i)
        lit = extend(token >> 4, running & (token >> 4 == 15))
        lit = torch.where(running, lit, 0)
        start = i
        i = i + lit
        match = running & (i < n)
        off = torch.where(match, at(i) | (at(i + 1) << 8), 0)
        i = torch.where(match, i + 2, i)
        ml = extend((token & 15) + MIN_MATCH, match & (token & 15 == 15))
        steps.append((start, lit, torch.where(match, ml, 0), off,
                      running.clone()))
        running = match & (i < n)
    if not steps:
        zero = torch.zeros((b, 0), dtype=torch.int64, device=comp.device)
        return zero, zero, zero, zero, zero.bool()
    return tuple(torch.stack(c, dim=1) for c in zip(*steps))


def lz4p_pack_plain(comp: torch.Tensor, clens: torch.Tensor, n: int,
                    split: bool = True):
    """Plain version of the pack kernel: comp (B, w) u8 LZ4 streams of
    blocks of at most n bytes, clens (B,) -> (out (B, encode_cap(n)) u8,
    zero past each row's bytes, olens (B,) i32), as the module note says."""
    b = comp.shape[0]
    dev = comp.device
    cap = encode_cap(n)
    start, lit, ml, off, valid = _lz4_sequences(comp, clens)
    lit = torch.where(valid, lit, 0)
    # the pieces of each sequence: xl literal pieces, then the rest of its
    # literals with the match's first piece, then xm more match pieces
    xl = torch.where(lit > U16, (lit - 1) // U16, 0) * split
    xm = torch.where(ml > U16, (ml - 1) // U16, 0) * split
    size = torch.where(valid, 1 + xl + xm, 0)
    ends = size.cumsum(1)
    first = ends - size
    nseq = ends[:, -1] if ends.shape[1] else torch.zeros(
        b, dtype=torch.int64, device=dev)
    smax = int(nseq.max()) if b else 0
    e = torch.arange(smax, device=dev).expand(b, smax).contiguous()
    k = (torch.searchsorted(first, e, right=True) - 1).clamp(min=0)
    j = e - first.gather(1, k)
    XL, XM = xl.gather(1, k), xm.gather(1, k)
    LIT, ML = lit.gather(1, k), ml.gather(1, k)
    q = j - XL                       # the entry's match piece, from 0
    ll_e = torch.where(j < XL, U16, torch.where(q == 0, LIT - U16 * XL, 0))
    ml_e = torch.where(q < 0, 0, torch.where(q < XM, U16, ML - U16 * XM))
    off_e = torch.where(ml_e > 0, off.gather(1, k), 0)
    cols = torch.stack([ll_e, ml_e, off_e], dim=1)      # (B, 3, S)
    over = (ll_e > U16) | (ml_e > U16)
    orig = (lit + ml).sum(1)
    lit_total = lit.sum(1)
    lit_first = lit.cumsum(1) - lit
    base = HDR + 6 * nseq
    total = base + lit_total
    n_stream = clens.to(torch.int64).clamp(0, comp.shape[1])[:, None]
    ok = ~(over.any(dim=1) | (valid & (start + lit > n_stream)).any(dim=1)
           | (total > cap))
    p = torch.arange(cap, device=dev).expand(b, cap).contiguous()
    word = torch.where(p < 4, nseq[:, None], orig[:, None])
    head = (word >> (8 * (p % 4))) & 0xFF
    c = ((p - HDR) // 2).clamp(min=0)
    col = torch.div(c, nseq[:, None].clamp(min=1), rounding_mode="floor")
    ent = c - col * nseq[:, None]
    flat = cols.reshape(b, -1)
    entry = _gather(flat, col.clamp(max=2) * max(smax, 1) + ent) if smax \
        else torch.zeros_like(p)
    colbyte = (entry >> (8 * ((p - HDR) % 2))) & 0xFF
    r = p - base[:, None]
    kk = (torch.searchsorted(lit_first, r.clamp(min=0), right=True)
          - 1).clamp(min=0)
    litbyte = _gather(comp.to(torch.int64),
                      start.gather(1, kk) + r - lit_first.gather(1, kk)) \
        if lit.shape[1] else torch.zeros_like(p)
    val = torch.where(p < HDR, head, torch.where(r < 0, colbyte, litbyte))
    keep = ok[:, None] & (p < total[:, None])
    out = torch.where(keep, val, 0).to(torch.uint8)
    return out, torch.where(ok, total, -1).to(torch.int32)


def lz4p_decode_batch_plain(comp: torch.Tensor, clens: torch.Tensor,
                            out_cap: int):
    """Plain version of the decoder: comp (B, w) u8, clens (B,) (read as at
    most w) -> (out (B, out_cap) u8, status (B,) i64)."""
    b, w = comp.shape
    dev = comp.device
    n = clens.to(torch.int64).clamp(0, w)
    src = comp.to(torch.int64)

    def u32(at):
        return sum(_read(src, torch.full_like(n, at + k)) << (8 * k)
                   for k in range(4))

    nseq, orig = u32(0), u32(4)
    bad = (n < HDR) | (orig > out_cap) | (HDR + 6 * nseq > n)
    nseq = torch.where(bad, 0, nseq)
    smax = int(nseq.max()) if b else 0
    t = torch.arange(smax, device=dev)[None, :]
    live = t < nseq[:, None]

    def column(c):
        at = HDR + 2 * (c * nseq[:, None] + t)
        return torch.where(live, _gather(src, at) | (_gather(src, at + 1)
                                                      << 8), 0)

    ll, ml, off = column(0), column(1), column(2)
    size = ll + ml
    o = size.cumsum(1) - size                  # output start of each
    lp = ll.cumsum(1) - ll                     # literal start of each
    base = HDR + 6 * nseq[:, None]
    ms = o + ll                                # match start
    fault = live & ((base + lp + ll > n[:, None]) | (ms > orig[:, None])
                    | ((ml > 0) & ((off == 0) | (off > ms)
                                   | (ms + ml > orig[:, None]))))
    total = size.sum(1)
    bad |= fault.any(dim=1) | (total != orig)
    status = torch.where(n == 0, 0, torch.where(bad, -1, orig))
    if smax == 0 or out_cap == 0:
        return torch.zeros((b, out_cap), dtype=torch.uint8,
                           device=dev), status
    p = torch.arange(out_cap, device=dev).expand(b, out_cap).contiguous()
    k = (torch.searchsorted(o, p, right=True) - 1).clamp(min=0)
    rel = p - o.gather(1, k)
    is_lit = rel < ll.gather(1, k)
    mk, offk = ms.gather(1, k), off.gather(1, k).clamp(min=1)
    ptr = torch.where(is_lit, p, mk - offk + (p - mk) % offk)
    ptr = ptr.clamp(0, out_cap - 1)
    val = _gather(src, base + lp.gather(1, k) + rel)
    while True:
        nxt = ptr.gather(1, ptr)
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    keep = p < torch.where(status > 0, status, 0)[:, None]
    return torch.where(keep, val.gather(1, ptr), 0).to(torch.uint8), status


def _lib(name: str):
    """The typed C entry point tpz_lz4p_<name> of csrc/lz4p.cu."""
    fn = getattr(_build.load("lz4p"), f"tpz_lz4p_{name}")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp, vp, ci, ci, vp, ci, vp, ci, vp]
                       if name == "pack"
                       else [vp, vp, ci, ci, vp, ci, vp, vp])
        fn.restype = ci
    return fn


def lz4p_pack(comp: torch.Tensor, clens: torch.Tensor, n: int,
              split: bool = True):
    """lz4p rows of the LZ4 streams of blocks of at most n bytes: comp
    (B, w) u8, clens (B,) i32 -> (out (B, encode_cap(n)) u8, zero past
    each row's bytes, olens (B,) i32; -1 for a row the XLA rule cannot
    write), as the module note says.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4p.cu's pack kernel on the current stream (no
    synchronisation)."""
    _check_pair("lz4p_pack", comp, clens)
    if comp.device.type == "cpu":
        return lz4p_pack_plain(comp, clens, n, split)
    b, w = comp.shape
    cap = encode_cap(n)
    dev = comp.device
    out = torch.zeros((b, cap), dtype=torch.uint8, device=dev)
    olens = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return out, olens
    fn = _lib("pack")
    with torch.cuda.device(dev):
        err = fn(comp.data_ptr(), clens.data_ptr(), b, w, out.data_ptr(),
                 cap, olens.data_ptr(), int(split),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4p_pack")
    lz4p_pack.launches += 1
    return out, olens


def lz4p_encode_batch(blocks: torch.Tensor, lengths: torch.Tensor,
                      hash_log: int = 16, xla: bool = False):
    """lz4p encode of every row: blocks (B, n) u8, lengths (B,) i32 ->
    (comp (B, encode_cap(n)) u8, zero past each row's bytes, clens (B,)
    i32).  xla=False is tpuzip's C++ rule: the single-probe lz4 parse
    (kernels/lz4_coder.py) at hash_log (outside 4..24 taken as 16), runs
    split.  xla=True is its XLA rule: its device lz4 parse
    (kernels/lz4_dense.py) at hash_log 15, whatever hash_log says, the
    columns unsplit; it takes blocks of at most 65536 bytes and raises
    ValueError naming the rows whose run reaches 65536 (fault 7)."""
    n = blocks.shape[1]
    if not xla:
        return lz4p_pack(*lz4_coder.lz4_encode_batch(blocks, lengths,
                                                     hash_log), n)
    if n > XLA_MAX_BLOCK:
        raise ValueError(f"lz4p's device encoder takes blocks of at most "
                         f"{XLA_MAX_BLOCK} bytes, not {n} (u16 columns; "
                         "tpuzip asserts)")
    comp, clens = lz4p_pack(*lz4_dense.lz4_dense_encode_batch(
        blocks, lengths, XLA_HASH_LOG), n, split=False)
    bad = torch.nonzero(clens < 0).flatten().tolist()
    if bad:
        raise ValueError(
            f"lz4p: blocks {bad[:8]} hold a literal run of 65536 bytes, "
            "which tpuzip's device encoder writes into a u16 column as 0: "
            "its container would not decode, so the port refuses it")
    return comp, clens


def lz4p_decode_batch(comp: torch.Tensor, clens: torch.Tensor,
                      out_cap: int):
    """lz4p decode of every row: comp (B, w) u8, clens (B,) i32 (read as at
    most w) -> (out (B, out_cap) u8, status (B,) i64), as the module note
    says.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4p.cu's decode kernel on the current stream (no
    synchronisation)."""
    _check_pair("lz4p_decode_batch", comp, clens)
    if comp.device.type == "cpu":
        return lz4p_decode_batch_plain(comp, clens, out_cap)
    b, w = comp.shape
    dev = comp.device
    out = torch.empty((b, out_cap), dtype=torch.uint8, device=dev)
    status = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return out, status
    fn = _lib("decode")
    with torch.cuda.device(dev):
        err = fn(comp.data_ptr(), clens.data_ptr(), b, w, out.data_ptr(),
                 out_cap, status.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4p_decode")
    lz4p_decode_batch.launches += 1
    return out, status


lz4p_pack.launches = 0
lz4p_decode_batch.launches = 0
