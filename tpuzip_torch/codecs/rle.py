"""Run-length codec (codec "rle"): row capacity.

Format: tpuzip.oracle.rle (a byte, and after two equal bytes a count of
the additional repeats, chained by 255).  The bytes are those of tpuzip's
C++ ``tpz_rle_encode``, which tpuzip's compress writes off the TPU: a
run's count bytes chain without bound.  compress_from_device writes
tpuzip's XLA encoder's form, which cuts runs into 256-byte segments.  The
kernels and their plain versions are in kernels/rle_coder.py.
"""

from __future__ import annotations


def encode_cap(n: int) -> int:
    """Row capacity of an encoded block of n bytes (tpuzip.codecs.rle):
    alternating pairs take 3 bytes for 2."""
    return 2 * n + 8
