"""LZ4 block and frame formats — pure-Python reference codec: a copy of
tpuzip/oracle/lz4.py (the block half: ``compress_block``,
``decompress_block``, ``worst_case_size``, ``_hash``; the frame half:
``MAGIC``, ``_BD_MAX_SIZES``, ``compress_frame``, ``decompress_frame``,
``_decompress_linked``).  The frame half is the format contract that
codecs/lz4_frame.py and io.py are held to.

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

from tpuzip_torch.oracle.xxh32 import xxh32

MAGIC = 0x184D2204
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


# ---------------------------------------------------------------------------
# Frame format
# ---------------------------------------------------------------------------

_BD_MAX_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


def compress_frame(data: bytes, block_max: int = 1 << 20,
                   content_checksum: bool = True,
                   block_checksum: bool = False) -> bytes:
    """LZ4 frame with independent blocks (the DP axis for the TPU build)."""
    bd_id = {v: k for k, v in _BD_MAX_SIZES.items()}[block_max]
    out = bytearray(struct.pack("<I", MAGIC))
    # FLG: version=01, block-independence=1, checksum flags
    flg = (1 << 6) | (1 << 5) | (int(block_checksum) << 4) | (int(content_checksum) << 2)
    bd = bd_id << 4
    descriptor = bytes([flg, bd])
    hc = (xxh32(descriptor) >> 8) & 0xFF
    out += descriptor + bytes([hc])
    for ofs in range(0, max(len(data), 1), block_max):
        chunk = data[ofs : ofs + block_max]
        if not chunk:
            break
        comp = compress_block(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp)) + comp
            if block_checksum:
                out += struct.pack("<I", xxh32(comp))
        else:  # stored block: MSB set
            out += struct.pack("<I", len(chunk) | 0x80000000) + chunk
            if block_checksum:
                out += struct.pack("<I", xxh32(chunk))
    out += struct.pack("<I", 0)  # EndMark
    if content_checksum:
        out += struct.pack("<I", xxh32(data))
    return bytes(out)


def decompress_frame(data: bytes) -> bytes:
    i = 0
    (magic,) = struct.unpack_from("<I", data, i)
    i += 4
    if magic != MAGIC:
        raise ValueError(f"bad LZ4 frame magic: {magic:#x}")
    flg = data[i]
    bd = data[i + 1]
    i += 2
    version = flg >> 6
    if version != 1:
        raise ValueError("unsupported LZ4 frame version")
    block_indep = (flg >> 5) & 1
    block_checksum = (flg >> 4) & 1
    content_size_flag = (flg >> 3) & 1
    content_checksum = (flg >> 2) & 1
    dict_id = flg & 1
    bd_id = (bd >> 4) & 0x7
    if bd_id not in _BD_MAX_SIZES:
        raise ValueError("bad BD byte")
    block_max = _BD_MAX_SIZES[bd_id]
    if content_size_flag:
        i += 8
    if dict_id:
        i += 4
    i += 1  # header checksum byte (tolerated, like the reference reader)
    out = bytearray()
    window = bytearray()  # for linked blocks
    while True:
        (blen,) = struct.unpack_from("<I", data, i)
        i += 4
        if blen == 0:
            break
        stored = bool(blen & 0x80000000)
        blen &= 0x7FFFFFFF
        if blen > block_max:
            raise ValueError("block length exceeds frame maximum")
        payload = data[i : i + blen]
        i += blen
        if block_checksum:
            (bc,) = struct.unpack_from("<I", data, i)
            i += 4
            if bc != xxh32(payload):
                raise ValueError("LZ4 block checksum mismatch")
        if stored:
            dec = payload
        elif block_indep:
            dec = decompress_block(payload, max_out=block_max)
        else:
            dec = _decompress_linked(payload, window, block_max)
        out += dec
        if not block_indep:
            window += dec
            window = window[-(1 << 16):]
    if content_checksum:
        (cc,) = struct.unpack_from("<I", data, i)
        if cc != xxh32(bytes(out)):
            raise ValueError("LZ4 content checksum mismatch")
    return bytes(out)


def _decompress_linked(src: bytes, window: bytearray, block_max: int) -> bytes:
    """Decode a block whose matches may reach into the previous window."""
    buf = bytearray(window)
    base = len(buf)
    i, n = 0, len(src)
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
        buf += src[i : i + lit_len]
        i += lit_len
        if i >= n:
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        match_len = (token & 0xF) + MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(buf) - offset
        if start < 0:
            raise ValueError("corrupt linked LZ4 block")
        for k in range(match_len):
            buf.append(buf[start + k])
    return bytes(buf[base:])
