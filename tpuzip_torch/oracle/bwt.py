"""Burrows–Wheeler transform oracle: a copy of the block transform of
tpuzip/oracle/bwt.py (its streaming block framing is not on any port path).

Semantics: the classic cyclic-rotation BWT — sort all n rotations of the
block, output the last column plus ``origin`` (the sorted position of
rotation 0).  The forward sort is prefix doubling over cyclic ranks with
``numpy.lexsort``, ties of periodic blocks broken by index; the inverse is
the counting-sort "next array" walk.
"""

from __future__ import annotations

import numpy as np


def rotation_sort(data: np.ndarray) -> np.ndarray:
    """Indices of cyclic rotations in lexicographic order (prefix doubling)."""
    n = len(data)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = data.astype(np.int64)
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while k < n:
        # cyclic second key
        second = rank[(idx + k) % n]
        order = np.lexsort((second, rank))
        key_r = rank[order]
        key_s = second[order]
        new_rank = np.empty(n, dtype=np.int64)
        changed = np.ones(n, dtype=bool)
        changed[1:] = (key_r[1:] != key_r[:-1]) | (key_s[1:] != key_s[:-1])
        new_rank[order] = np.cumsum(changed) - 1
        rank = new_rank
        if rank.max() == n - 1:
            break
        k <<= 1
    return np.argsort(rank, kind="stable").astype(np.int64)


def encode_block(block: bytes) -> tuple[bytes, int]:
    """-> (last column L, origin)."""
    data = np.frombuffer(block, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return b"", 0
    sa = rotation_sort(data)
    L = data[(sa - 1) % n]
    origin = int(np.nonzero(sa == 0)[0][0])
    return L.tobytes(), origin


def decode_block(last_col: bytes, origin: int) -> bytes:
    """Inverse BWT via counting sort + next-array walk (reference scheme)."""
    L = np.frombuffer(last_col, dtype=np.uint8)
    n = len(L)
    if n == 0:
        return b""
    # next[i]: the row in sorted order that follows row i's rotation.
    # Stable-sort positions of L gives, for each first-column slot, its source
    # row in L — the classic inversion table.
    order = np.argsort(L, kind="stable").astype(np.int64)
    out = np.empty(n, dtype=np.uint8)
    p = order[origin]
    for i in range(n):
        out[i] = L[p]
        p = order[p]
    return out.tobytes()
