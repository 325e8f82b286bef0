"""Burrows–Wheeler transform of a batch of blocks, in PyTorch on the
tensor's own device.

Port of tpuzip/codecs/bwt.py.  Format and semantics: the cyclic-rotation
BWT of tpuzip.oracle.bwt (last column L and ``origin``, the sorted position
of rotation 0), including its ties: rotations of a periodic block that are
equal sort by index.  The JAX package computes this with XLA sorts and
gathers outside any Pallas kernel; here they are ``torch.sort`` and
``torch.gather``.

Forward: prefix doubling over cyclic ranks.  The first round ranks the
first HEAD cyclic bytes of every rotation at once (one int64 key); each
later round sorts the pair (rank, rank at +k), packed into one int64 key,
stably, until every row's ranks are unique (one host sync a round) or k
reaches the row width; a final stable sort breaks periodic ties by index.
Positions at or past a row's length sort last, and the cyclic shift is
taken mod the length, as ``encode_block`` does.

Inverse: a stable sort of L (key 256 past the length) gives the "next"
permutation; the walk from ``origin`` is filled by pointer doubling, in
ceil(log2 N) rounds of full-row gathers (``decode_block``).
"""

from __future__ import annotations

import torch

HEAD = 7   # cyclic bytes of the first round's key (56 bits of an int64)


def _cyclic(x: torch.Tensor, k: int, safe_len: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """x[:, (i + k) mod length] for every position i of every row."""
    return torch.gather(x, 1, (idx + k) % safe_len)


def _dense_ranks(keys: torch.Tensor, valid: torch.Tensor, big: int):
    """Stable sort of each row's keys -> (the sort order, the dense rank of
    every position: equal keys share a rank; positions past the length get
    `big`)."""
    sk, order = torch.sort(keys, dim=1, stable=True)
    changed = torch.ones_like(sk, dtype=torch.int64)
    changed[:, 1:] = sk[:, 1:] != sk[:, :-1]
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.cumsum(changed, dim=1) - 1)
    return order, torch.where(valid, rank, big)


def encode_batch(blocks: torch.Tensor, lengths: torch.Tensor):
    """(B, N) u8 blocks, (B,) lengths -> (L (B, N) u8, origins (B,) i32).
    L is 0 at and past each length; an empty row has origin 0."""
    b, n = blocks.shape
    dev = blocks.device
    lens = lengths.to(torch.int64).clamp(0, n)
    if b == 0 or n == 0:
        return (torch.zeros((b, n), dtype=torch.uint8, device=dev),
                torch.zeros(b, dtype=torch.int32, device=dev))
    idx = torch.arange(n, device=dev).expand(b, n)
    valid = idx < lens[:, None]
    safe_len = lens.clamp(min=1)[:, None]
    big = n + 1                       # above every rank of a valid position
    data = blocks.to(torch.int64)
    head = torch.zeros((b, n), dtype=torch.int64, device=dev)
    for j in range(HEAD):
        head = (head << 8) | _cyclic(data, j, safe_len, idx)
    order, rank = _dense_ranks(torch.where(valid, head, 1 << 62), valid, big)
    del head
    k = HEAD
    while True:
        top = torch.where(valid, rank, -1).amax(dim=1)
        resolved = bool(((top + 1) == lens).all())   # ranks 0..len-1 unique
        if resolved or k >= n:
            break
        second = torch.where(valid, _cyclic(rank, k, safe_len, idx), big)
        order, rank = _dense_ranks(rank * (n + 2) + second, valid, big)
        k *= 2
    if resolved:      # the last sort's order is the suffix array already
        sa = order
    else:             # periodic ties: equal rotations sort by index
        sa = torch.sort(rank, dim=1, stable=True).indices
    L = torch.gather(blocks, 1, (sa - 1) % safe_len)
    L = torch.where(valid, L, 0).to(torch.uint8)
    origins = (sa == 0).to(torch.int8).argmax(dim=1)
    origins = torch.where(lens > 0, origins, 0).to(torch.int32)
    return L, origins


def decode_batch(L: torch.Tensor, origins: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Inverse BWT: L (B, N) u8, origins (B,), lengths (B,) -> (B, N) u8,
    0 at and past each length.  An origin out of range is clamped (the
    block then decodes wrong and fails its checksum, as in tpuzip)."""
    b, n = L.shape
    dev = L.device
    lens = lengths.to(torch.int64).clamp(0, n)
    if b == 0 or n == 0:
        return torch.zeros((b, n), dtype=torch.uint8, device=dev)
    valid = torch.arange(n, device=dev)[None, :] < lens[:, None]
    key = torch.where(valid, L.to(torch.int16), 256)
    order = torch.sort(key, dim=1, stable=True).indices
    # the orbit of origin under `order`: pos[:, t] = order^(t+1)(origin)
    pos = torch.empty((b, n), dtype=torch.int64, device=dev)
    start = origins.to(torch.int64).clamp(0, n - 1)[:, None]
    pos[:, :1] = torch.gather(order, 1, start)
    step = order                      # order^filled
    filled = 1
    while filled < n:
        take = min(filled, n - filled)
        pos[:, filled : filled + take] = torch.gather(step, 1, pos[:, :take])
        filled += take
        if filled < n:
            step = torch.gather(step, 1, step)
    out = torch.gather(L, 1, pos)
    return torch.where(valid, out, 0).to(torch.uint8)
