"""Distance coding oracle: a copy of tpuzip/oracle/dc.py.

The sequence is partitioned into *runs*.  Every run head is either a
symbol's first occurrence (header) or was scheduled by the previous run of
the same symbol (distance from that run's end), so a left-to-right run walk
inverts the transform exactly.

Format:
  [n: u32 LE] [first[256]: u32 LE each, == n if symbol absent]
  [LEB128 varint distances, one per run in run order:
     d = next_run_head_of_symbol - run_end  (always >= 2), or 0 = no more]
"""

from __future__ import annotations

import struct


def _write_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, i
        shift += 7


def encode(data: bytes) -> bytes:
    n = len(data)
    out = bytearray(struct.pack("<I", n))
    first = [n] * 256
    occurrences: dict[int, list[int]] = {}
    # run decomposition
    runs: list[tuple[int, int, int]] = []  # (sym, head, end_exclusive)
    i = 0
    while i < n:
        s = data[i]
        j = i
        while j < n and data[j] == s:
            j += 1
        if first[s] == n:
            first[s] = i
        occurrences.setdefault(s, []).append(i)
        runs.append((s, i, j))
        i = j
    for f in first:
        out += struct.pack("<I", f)
    # for each run (in order): distance from run end to the symbol's next head
    next_head: dict[int, list[int]] = {s: heads for s, heads in occurrences.items()}
    cursor = {s: 0 for s in occurrences}
    for s, head, end in runs:
        cursor[s] += 1
        heads = next_head[s]
        if cursor[s] < len(heads):
            d = heads[cursor[s]] - (end - 1)
            _write_varint(out, d)
        else:
            _write_varint(out, 0)
    return bytes(out)


def decode(data: bytes) -> bytes:
    (n,) = struct.unpack_from("<I", data, 0)
    i = 4
    scheduled: dict[int, int] = {}  # position -> symbol
    for s in range(256):
        (f,) = struct.unpack_from("<I", data, i)
        i += 4
        if f < n:
            scheduled[f] = s
    out = bytearray(n)
    pos = 0
    while pos < n:
        if pos not in scheduled:
            raise ValueError(f"DC decode: no run head scheduled at {pos}")
        s = scheduled.pop(pos)
        # run extends until the next scheduled head
        nxt = min(scheduled) if scheduled else n
        for k in range(pos, nxt):
            out[k] = s
        run_end = nxt - 1
        d, i = _read_varint(data, i)
        if d:
            target = run_end + d
            if target >= n or target in scheduled:
                raise ValueError("DC decode: bad distance")
            scheduled[target] = s
            # the newly scheduled head may shorten this run
            if target < nxt:
                raise ValueError("DC decode: distance points into current run")
        pos = nxt
    return bytes(out)
