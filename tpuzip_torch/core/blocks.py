"""Block segmentation: a copy of ``chunk`` and ``unchunk`` of
tpuzip/core/blocks.py.

A corpus becomes a ``(num_blocks, block_size)`` u8 array and a lengths
vector; the lengths carry the ragged truth.  The port runs on one device
and never pads the batch to a mesh, so tpuzip's ``chunk_padded`` has no
counterpart here.
"""

from __future__ import annotations

import numpy as np


def chunk(data: bytes, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """bytes -> (blocks (B, block_size) u8 zero-padded, lengths (B,) i32).

    Empty input yields a single empty block so downstream shapes stay static.
    """
    n = len(data)
    num_blocks = max((n + block_size - 1) // block_size, 1)
    blocks = np.zeros((num_blocks, block_size), dtype=np.uint8)
    lengths = np.zeros(num_blocks, dtype=np.int32)
    arr = np.frombuffer(data, dtype=np.uint8)
    for b in range(num_blocks):
        piece = arr[b * block_size : (b + 1) * block_size]
        blocks[b, : len(piece)] = piece
        lengths[b] = len(piece)
    return blocks, lengths


def unchunk(blocks: np.ndarray, lengths: np.ndarray) -> bytes:
    """Inverse of :func:`chunk`."""
    blocks = np.asarray(blocks)
    lengths = np.asarray(lengths)
    return b"".join(
        blocks[b, : int(lengths[b])].tobytes() for b in range(blocks.shape[0])
    )
