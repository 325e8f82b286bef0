"""LZ4 block codec (codec "lz4"): row capacities and the Lz4Config knobs.

Format: the public LZ4 block spec.  At max_chain 1 (the default) the bytes
equal tpuzip.oracle.lz4's greedy single-probe encoder, which is what tpuzip
writes off the TPU (its C++ ``tpz_lz4_compress``): kernels/lz4_coder.py
holds the kernels and their plain versions.  max_chain > 1 writes the
bytes of tpuzip's chained C++ encoder (``tpz_lz4_compress_chained``), a
best-of-chain parse with one step of lazy matching: kernels/lz4_chain.py.
tpuzip's device encoder (compress_from_device, and device_encode=True,
which wins over max_chain) is kernels/lz4_dense.py.
"""

from __future__ import annotations

HASH_LOG = 16       # tpz_lz4_compress's table when hash_log is out of range
SLACK = 64          # tpuzip.codecs.lz4's row padding


def encode_cap(n: int) -> int:
    """The largest payload a block of n bytes may declare
    (tpuzip.codecs.lz4.encode_cap: the spec bound plus SLACK)."""
    return n + n // 255 + 16 + SLACK


def hash_log(value: int) -> int:
    """The table size the encoder uses: 4..24 as given, else 16, as the C++
    encoder does (tpuzip's container at hash_log 30 is the default one)."""
    return value if 4 <= value <= 24 else HASH_LOG
