"""LZ4 block encode and decode over a batch of blocks: the CUDA kernels'
wrappers and their plain PyTorch versions.

tpuzip has no Pallas kernel for LZ4.  Off the TPU its runner encodes codec
"lz4" with the C++ greedy single-probe encoder ``tpz_lz4_compress`` and
decodes with ``tpz_lz4_decompress`` (csrc/tpuzip_host.cpp:190,
:252); the port may not call them, so csrc/lz4_encode.cu and
csrc/lz4_decode.cu replace them, one warp a block, and the functions here
are theirs:

  encode  the bytes of tpuzip.oracle.lz4.compress_block(block, hash_log),
          hash_log outside 4..24 taken as 16; an empty block is b"\\x00".
  decode  tpz_lz4_decompress's status: the decoded length, or -1 for an
          offset of 0 or past the bytes decoded so far, a literal run past
          the stream or past out_cap, a match past out_cap, or a truncated
          offset or length extension.  A stream that ends right after a
          literal run is complete, and an empty stream decodes to 0 bytes.
          The output row holds the decoded bytes and 0 after them; a row
          with status -1 is all 0.  The history mode (a linked LZ4 frame's
          blocks, tpuzip/oracle/lz4.py:265 _decompress_linked) decodes
          each row after up to 64 KiB of the output before it, into
          which its offsets may reach.

The plain versions run every row at once.  The encoder probes a window of
WINDOW positions a step (the kernel's construction, at 8 or 32): inside
it a position's candidate is the last earlier position of the window with
its hash, else the table's entry, so a step ends at the window's first
verified match or after the window, and the sequences are serialised at
the end, each output byte computed from its sequence.  The decoder parses
one sequence a row a step, then resolves every output byte to a literal by
pointer doubling: byte m of a match at o with offset off is byte
o - off + (m % off), always before o.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpuzip_torch.codecs.lz4 import hash_log as resolve_hash_log
from tpuzip_torch.kernels import _build

HASH_MUL = 2654435761
MIN_MATCH = 4
MF_LIMIT = 12         # no match starts in a block's last 12 bytes
LAST_LITERALS = 5     # nor runs into its last 5
WINDOW = 64           # positions a step of the plain encoder
EXT = 256             # bytes a round of the plain match extension
POOL_BYTES = 1 << 30  # the encoder kernel's hash tables, at most
DECODE_TILE = 1024    # bytes of a stream tile the decoder kernel stages


def encode_cap(n: int) -> int:
    """Row capacity of an encoded block of n bytes: the spec's bound, which
    the greedy parse never exceeds (a match of 4 or more bytes costs at most
    3 bytes and the length extensions of its literals)."""
    return n + n // 255 + 16


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for u32 values held in int64, in products below
    2^49 (x * c itself may pass int64)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _ext_len(length: torch.Tensor) -> torch.Tensor:
    """Extension bytes of a literal run or match length past its nibble."""
    return torch.where(length >= 15, (length - 15) // 255 + 1, 0)


def _ext_byte(length: torch.Tensor, e: torch.Tensor,
              count: torch.Tensor) -> torch.Tensor:
    """Byte e of the `count` extension bytes of `length`: 255, then the
    remainder."""
    return torch.where(e < count - 1, 255, (length - 15) - 255 * (count - 1))


def _serialise(src, lit_start, lit_len, off, mlen, nseq, cap: int):
    """(B, cap) u8 LZ4 streams and their lengths from each row's sequences:
    columns 0 .. nseq-1 carry a match, column nseq the last literals."""
    b, s = lit_len.shape
    dev = src.device
    col = torch.arange(s, device=dev)[None, :]
    valid = col <= nseq[:, None]
    has_match = col < nseq[:, None]
    ml = torch.where(has_match, mlen - MIN_MATCH, 0)
    nlx = _ext_len(lit_len)
    nmx = torch.where(has_match, _ext_len(ml), 0)
    size = torch.where(valid, 1 + nlx + lit_len
                       + torch.where(has_match, 2 + nmx, 0), 0)
    ends = size.cumsum(1)
    start = ends - size
    total = ends[:, -1]
    p = torch.arange(cap, device=dev).expand(b, cap).contiguous()
    k = (torch.searchsorted(start, p, right=True) - 1).clamp(min=0)
    q = p - start.gather(1, k)
    L, A = lit_len.gather(1, k), lit_start.gather(1, k)
    NLX, NMX = nlx.gather(1, k), nmx.gather(1, k)
    ML, OFF, HM = ml.gather(1, k), off.gather(1, k), has_match.gather(1, k)
    token = (L.clamp(max=15) << 4) | torch.where(HM, ML.clamp(max=15), 0)
    after = q - 1 - NLX - L        # 0, 1: the offset; from 2: match ext
    val = torch.where(
        q == 0, token, torch.where(
            q <= NLX, _ext_byte(L, q - 1, NLX), torch.where(
                after < 0, _gather(src, A + q - 1 - NLX), torch.where(
                    after == 0, OFF & 0xFF, torch.where(
                        after == 1, OFF >> 8,
                        _ext_byte(ML, after - 2, NMX))))))
    val = torch.where(p < total[:, None], val, 0)
    return val.to(torch.uint8), total.to(torch.int32)


def lz4_encode_batch_plain(blocks: torch.Tensor, lengths: torch.Tensor,
                           hash_log: int = 16):
    """Plain version of the encoder: blocks (B, n) u8, lengths (B,) ->
    (comp (B, encode_cap(n)) u8, zero past each stream, clens (B,) i32)."""
    hl = resolve_hash_log(hash_log)
    b, n = blocks.shape
    dev = blocks.device
    cap = encode_cap(n)
    lens = lengths.to(torch.int64).clamp(0, n)
    pad = max(WINDOW, EXT) + 8
    src = F.pad(blocks, (0, pad)).to(torch.int64)          # (B, n + pad)
    width = n + WINDOW
    words = (src[:, :width] | (src[:, 1:width + 1] << 8)
             | (src[:, 2:width + 2] << 16) | (src[:, 3:width + 3] << 24))
    hashes = _mul32(words, HASH_MUL) >> (32 - hl)
    table = torch.full((b, 1 << hl), -1, dtype=torch.int32, device=dev)
    nmax = n // MIN_MATCH + 2                    # sequences a row, at most
    lit_start = torch.zeros((b, nmax + 1), dtype=torch.int64, device=dev)
    lit_len = torch.zeros_like(lit_start)
    off = torch.zeros_like(lit_start)
    mlen = torch.zeros_like(lit_start)
    nseq = torch.zeros(b, dtype=torch.int64, device=dev)
    limit = (lens - MF_LIMIT).clamp(min=0)
    end = lens - LAST_LITERALS
    i = torch.zeros(b, dtype=torch.int64, device=dev)      # next probe
    anchor = torch.zeros_like(i)
    win = torch.arange(WINDOW, device=dev)
    earlier = torch.tril(torch.ones(WINDOW, WINDOW, dtype=torch.bool,
                                    device=dev), -1)
    ext = torch.arange(EXT, device=dev)
    while True:
        active = i < limit
        if not bool(active.any()):
            break
        pos = i[:, None] + win
        live = active[:, None] & (pos < limit[:, None])
        posc = pos.clamp(max=width - 1)
        h, w = hashes.gather(1, posc), words.gather(1, posc)
        # the last earlier position of the window with the same hash
        same = (h[:, :, None] == h[:, None, :]) & earlier
        inner = torch.where(same, pos[:, None, :], -1).amax(dim=2)
        cand = torch.where(inner >= 0, inner,
                           table.gather(1, h).to(torch.int64))
        ok = (live & (cand >= 0) & (pos - cand <= 0xFFFF)
              & (_gather(words, cand) == w))
        found = ok.any(dim=1)
        k = torch.where(found, ok.to(torch.int8).argmax(dim=1), WINDOW)
        # every probed position goes into the table, the match's first too
        probed = live & (win <= k[:, None])
        table.scatter_reduce_(1, h, torch.where(probed, pos, -1).to(
            torch.int32), reduce="amax")
        at = i + k
        c = cand.gather(1, k.clamp(max=WINDOW - 1)[:, None]).squeeze(1)
        # extend the matches forward, EXT bytes a round, up to n - 5
        m, mc, run = at + MIN_MATCH, c + MIN_MATCH, found.clone()
        while bool(run.any()):
            a, bb = m[:, None] + ext, mc[:, None] + ext
            stop = ((a >= end[:, None])
                    | (_gather(src, a) != _gather(src, bb)))
            first = torch.where(stop.any(dim=1),
                                stop.to(torch.int8).argmax(dim=1), EXT)
            m = torch.where(run, m + first, m)
            mc = torch.where(run, mc + first, mc)
            run &= first == EXT
        slot = torch.where(found, nseq, nmax)[:, None]
        lit_start.scatter_(1, slot, anchor[:, None])
        lit_len.scatter_(1, slot, (at - anchor)[:, None])
        off.scatter_(1, slot, (at - c)[:, None])
        mlen.scatter_(1, slot, (m - at)[:, None])
        nseq += found
        anchor = torch.where(found, m, anchor)
        i = torch.where(found, m, torch.where(active, i + WINDOW, i))
    last = nseq[:, None]
    lit_start.scatter_(1, last, anchor[:, None])
    lit_len.scatter_(1, last, (lens - anchor)[:, None])
    return _serialise(src, lit_start, lit_len, off, mlen, nseq, cap)


def _gather(src: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """src[row, at] with `at` clamped into the row."""
    return src.gather(1, at.clamp(0, src.shape[1] - 1))


def _read(src: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """src[row, at[row]] for every row, `at` clamped into the row."""
    return _gather(src, at[:, None]).squeeze(1)


def lz4_decode_batch_plain(comp: torch.Tensor, clens: torch.Tensor,
                           out_cap: int, history: torch.Tensor | None = None):
    """Plain version of the decoder: comp (B, w) u8, clens (B,) (read as at
    most w), history None or (B, h) u8 -> (out (B, out_cap) u8, status
    (B,) i64).  With a history, row r decodes after history[r] as if those
    h bytes were its output so far (its matches may reach into them), and
    out and status hold its own bytes."""
    b, w = comp.shape
    dev = comp.device
    h = 0 if history is None else history.shape[1]
    n = clens.to(torch.int64).clamp(0, w)
    src = comp.to(torch.int64)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    i, o = zero.clone(), zero + h
    status = zero + h
    running = n > 0
    segs = []          # per step: (out start, length, literal source or -1,
    #                     offset) of the literal run, then of the match
    if h:              # the history: a literal run read past the stream
        src = torch.cat([src, history.to(torch.int64)], dim=1)
        segs.append((zero, zero + h, zero + w, zero))
    row_cap = out_cap
    out_cap += h

    def fail(rows):
        nonlocal running
        status.masked_fill_(rows, -1)
        running = running & ~rows

    def length_ext(length, rows):
        """Add a length's extension bytes (rows whose nibble was 15)."""
        nonlocal i
        more = rows.clone()
        while bool(more.any()):
            fail(more & (i >= n))
            more &= running
            byte = _read(src, i)
            length = torch.where(more, length + byte, length)
            i = torch.where(more, i + 1, i)
            more &= byte == 255
        return length

    while bool(running.any()):
        # a stream may end after a match, as after a literal run
        done = running & (i >= n)
        status = torch.where(done, o, status)
        running = running & ~done
        token = _read(src, i)
        i = torch.where(running, i + 1, i)
        lit = length_ext(token >> 4, running & (token >> 4 == 15))
        fail(running & ((i + lit > n) | (o + lit > out_cap)))
        lit = torch.where(running, lit, 0)
        segs.append((o, lit, i, zero))
        i, o = i + lit, o + lit
        done = running & (i >= n)
        status = torch.where(done, o, status)
        running = running & ~done
        fail(running & (i + 2 > n))
        offset = _read(src, i) | (_read(src, i + 1) << 8)
        i = torch.where(running, i + 2, i)
        fail(running & ((offset == 0) | (offset > o)))
        ml = length_ext((token & 15) + MIN_MATCH,
                        running & (token & 15 == 15))
        fail(running & (o + ml > out_cap))
        ml = torch.where(running, ml, 0)
        segs.append((o, ml, torch.full_like(i, -1), offset))
        o = o + ml
    out = torch.zeros((b, row_cap), dtype=torch.uint8, device=dev)
    if not segs or row_cap == 0:
        return out, torch.where(status >= 0, status - h, status)
    start, length, lsrc, offset = (torch.stack(c, dim=1) for c in zip(*segs))
    # every byte's segment: the last one starting at or before it (a zero
    # length segment shares its start with the next one, which wins)
    p = torch.arange(out_cap, device=dev).expand(b, out_cap).contiguous()
    k = (torch.searchsorted(start, p, right=True) - 1).clamp(min=0)
    q = p - start.gather(1, k)
    is_lit = lsrc.gather(1, k) >= 0
    offk = offset.gather(1, k).clamp(min=1)
    ptr = torch.where(is_lit, p, start.gather(1, k) - offk + q % offk)
    ptr = ptr.clamp(0, out_cap - 1)
    val = _gather(src, lsrc.gather(1, k) + q)
    while True:
        nxt = ptr.gather(1, ptr)
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    keep = (p < status[:, None]) & (p >= h)
    out = torch.where(keep, val.gather(1, ptr), 0).to(torch.uint8)
    return out[:, h:], torch.where(status >= 0, status - h, status)


def _lib(name: str, entry: str | None = None):
    """The typed C entry point tpz_<entry or name> of csrc/<name>.cu."""
    lib = _build.load(name)
    entry = entry or name
    fn = getattr(lib, f"tpz_{entry}")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"lz4_encode": [vp, vp, ci, ci, vp, ci, vp, vp, ci, ci,
                                      vp],
                       "lz4_decode": [vp, vp, ci, ci, vp, ci, vp, vp],
                       "lz4_decode_history": [vp, vp, ci, ci, vp, ci, ci, vp,
                                              vp]}[entry]
        fn.restype = ci
    return fn


def table_count(b: int, hash_log: int) -> int:
    """Hash tables that a launch of csrc/lz4_encode.cu on b rows at
    hash_log gets: one a CUDA block, or, where b tables would pass
    POOL_BYTES, a pool of fewer, whose blocks walk the rows by a
    grid-stride loop."""
    return max(1, min(b, POOL_BYTES // (4 << hash_log)))


def _check_pair(name: str, rows: torch.Tensor, lens: torch.Tensor) -> None:
    if rows.dtype != torch.uint8 or lens.dtype != torch.int32:
        raise TypeError(f"{name} takes u8 rows and i32 lengths")
    if rows.dim() != 2 or lens.shape != rows.shape[:1]:
        raise ValueError(f"shape mismatch: rows {tuple(rows.shape)}, "
                         f"lengths {tuple(lens.shape)}")
    if rows.device != lens.device:
        raise ValueError("rows and lengths must share a device")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} for device {rows.device}")
    if rows.device.type == "cuda" and not (rows.is_contiguous()
                                           and lens.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def lz4_encode_batch(blocks: torch.Tensor, lengths: torch.Tensor,
                     hash_log: int = 16):
    """LZ4 block encode of every row: blocks (B, n) u8, lengths (B,) i32 ->
    (comp (B, encode_cap(n)) u8, zero past each stream, clens (B,) i32).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4_encode.cu on the current stream (no synchronisation)."""
    _check_pair("lz4_encode_batch", blocks, lengths)
    if blocks.device.type == "cpu":
        return lz4_encode_batch_plain(blocks, lengths, hash_log)
    hl = resolve_hash_log(hash_log)
    b, n = blocks.shape
    cap = encode_cap(n)
    dev = blocks.device
    comp = torch.zeros((b, cap), dtype=torch.uint8, device=dev)
    clens = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return comp, clens
    ntab = table_count(b, hl)
    tables = torch.empty(ntab << hl, dtype=torch.int32, device=dev)
    fn = _lib("lz4_encode")
    with torch.cuda.device(dev):
        err = fn(blocks.data_ptr(), lengths.data_ptr(), b, n,
                 comp.data_ptr(), cap, clens.data_ptr(), tables.data_ptr(),
                 ntab, hl, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4_encode")
    lz4_encode_batch.launches += 1
    return comp, clens


def lz4_decode_batch(comp: torch.Tensor, clens: torch.Tensor, out_cap: int,
                     history: torch.Tensor | None = None):
    """LZ4 block decode of every row: comp (B, w) u8, clens (B,) i32 (read
    as at most w) -> (out (B, out_cap) u8, status (B,) i64), as the module
    note says.  history, None or (B, h) u8 on the rows' device, is the
    history mode (the blocks of a linked LZ4 frame): row r decodes after
    the h bytes of history[r], its matches reaching into them, and out and
    status hold its own bytes (out is then a view of rows of h + out_cap).

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/lz4_decode.cu (tpz_lz4_decode_history with a history) on the
    current stream (no synchronisation); the history mode counts its own
    launches (lz4_decode_history.launches)."""
    _check_pair("lz4_decode_batch", comp, clens)
    if history is not None and (history.dtype != torch.uint8
                                or history.dim() != 2
                                or history.shape[0] != comp.shape[0]
                                or history.device != comp.device):
        raise ValueError("history must be (B, h) u8 beside the rows")
    if comp.device.type == "cpu":
        return lz4_decode_batch_plain(comp, clens, out_cap, history)
    if history is not None:
        return lz4_decode_history(comp, clens, out_cap, history)
    b, w = comp.shape
    dev = comp.device
    out = torch.empty((b, out_cap), dtype=torch.uint8, device=dev)
    status = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return out, status
    fn = _lib("lz4_decode")
    with torch.cuda.device(dev):
        err = fn(comp.data_ptr(), clens.data_ptr(), b, w, out.data_ptr(),
                 out_cap, status.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4_decode")
    lz4_decode_batch.launches += 1
    return out, status


def lz4_decode_history(comp: torch.Tensor, clens: torch.Tensor,
                       out_cap: int, history: torch.Tensor):
    """lz4_decode_batch's history mode on CUDA tensors: each output row is
    the history's h bytes, then out_cap of its own; returns the own bytes
    (a view) and the status."""
    b, w = comp.shape
    h = history.shape[1]
    full = torch.empty((b, h + out_cap), dtype=torch.uint8, device=comp.device)
    status = torch.empty(b, dtype=torch.int64, device=comp.device)
    if b == 0:
        return full[:, h:], status
    full[:, :h] = history
    fn = _lib("lz4_decode", "lz4_decode_history")
    with torch.cuda.device(comp.device):
        err = fn(comp.data_ptr(), clens.data_ptr(), b, w, full.data_ptr(),
                 h + out_cap, h, status.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lz4_decode_history")
    lz4_decode_history.launches += 1
    return full[:, h:], status


lz4_encode_batch.launches = 0
lz4_decode_batch.launches = 0
lz4_decode_history.launches = 0
