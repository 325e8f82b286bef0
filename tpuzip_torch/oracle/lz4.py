"""LZ4 block format — pure-Python reference codec: a copy of the block half
of tpuzip/oracle/lz4.py (``compress_block``, ``decompress_block``,
``worst_case_size``, ``_hash``).  The frame half, which needs xxh32, waits
for the port of the LZ4 frame format (ROADMAP.md, queue 1, item 12).

Encoder policy: greedy single-probe hash-table match search with the
multiplicative hash ``seq * 2654435761 >> (32 - HASH_LOG)``, the policy of
tpuzip's C++ encoder (``tpz_lz4_compress``), which tpuzip's runner uses for
codec "lz4" off the TPU.

Block format recap:
  repeat:
    token byte: hi nibble = literal length (15 => +0xFF ext bytes),
                lo nibble = match length - 4 (15 => +0xFF ext bytes)
    <literals> <offset u16 LE (1..65535)> <match ext bytes>
  stream ends with a literals-only sequence.
Encoder end-of-block rules: last 5 bytes are always literals; a match may not
start within the last 12 bytes (both per the spec; inputs < 13 bytes are
emitted as all-literals).
"""

from __future__ import annotations

import struct

MIN_MATCH = 4
# spec: last 5 bytes literals; no match starting in last 12 bytes
MF_LIMIT = 12
LAST_LITERALS = 5
HASH_LOG = 16
HASH_MUL = 2654435761


def worst_case_size(n: int) -> int:
    """Maximum compressed size of an n-byte block (spec bound)."""
    return n + n // 255 + 16


# ---------------------------------------------------------------------------
# Block codec
# ---------------------------------------------------------------------------

def _hash(seq: int, hash_log: int = HASH_LOG) -> int:
    return ((seq * HASH_MUL) & 0xFFFFFFFF) >> (32 - hash_log)


def compress_block(src: bytes, hash_log: int = HASH_LOG) -> bytes:
    """Greedy single-probe hash-table LZ4 block encoder.

    Mirrors the reference encoder's policy (one hash-table slot per hash, no
    chains, greedy accept of any >=4-byte verified match) so compressed size
    tracks the reference's.  hash_log sizes the table (2^hash_log slots):
    smaller tables collide more and find fewer matches — same format.
    """
    n = len(src)
    out = bytearray()
    if n == 0:
        return b"\x00"  # token: 0 literals — canonical empty block
    table = {}
    anchor = 0  # start of pending literal run
    i = 0
    limit = max(n - MF_LIMIT, 0)  # matches may not start in the last 12 bytes
    while i < limit:
        seq = int.from_bytes(src[i : i + 4], "little")
        h = _hash(seq, hash_log)
        cand = table.get(h, -1)
        table[h] = i
        if (
            cand >= 0
            and i - cand <= 0xFFFF
            and src[cand : cand + 4] == src[i : i + 4]
        ):
            # extend match forward (may not run into the last 5 bytes)
            m = i + 4
            c = cand + 4
            end = n - LAST_LITERALS
            while m < end and src[m] == src[c]:
                m += 1
                c += 1
            match_len = m - i
            lit_len = i - anchor
            _emit_sequence(out, src, anchor, lit_len, i - cand, match_len)
            i = m
            anchor = m
        else:
            i += 1
    # trailing literal run
    lit_len = n - anchor
    token = (min(lit_len, 15) << 4)
    out.append(token)
    _emit_len_ext(out, lit_len, 15)
    out += src[anchor:n]
    return bytes(out)


def _emit_sequence(out: bytearray, src: bytes, anchor: int, lit_len: int,
                   offset: int, match_len: int) -> None:
    ml = match_len - MIN_MATCH
    token = (min(lit_len, 15) << 4) | min(ml, 15)
    out.append(token)
    _emit_len_ext(out, lit_len, 15)
    out += src[anchor : anchor + lit_len]
    out += struct.pack("<H", offset)
    _emit_len_ext(out, ml, 15)


def _emit_len_ext(out: bytearray, length: int, nibble_max: int) -> None:
    if length >= nibble_max:
        rem = length - nibble_max
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)


def decompress_block(src: bytes, max_out: int | None = None) -> bytes:
    """Spec-conformant LZ4 block decoder (the reference's hot loop)."""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        out += src[i : i + lit_len]
        i += lit_len
        if max_out is not None and len(out) > max_out:
            raise ValueError("LZ4 block output exceeds limit")
        if i >= n:
            break  # last sequence is literals-only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero offset")
        match_len = (token & 0xF) + MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: offset beyond output")
        # overlap-safe byte-wise copy (offset may be < match_len)
        for k in range(match_len):
            out.append(out[start + k])
        if max_out is not None and len(out) > max_out:
            raise ValueError("LZ4 block output exceeds limit")
    return bytes(out)
