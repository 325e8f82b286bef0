"""Adaptive arithmetic (ari) codec: stream capacity and the model knobs.

Format: tpuzip.oracle.ari, a carryless Subbotin 32-bit range coder over an
adaptive order-0 table model.  The model's frequency table only ever holds
totals below ``threshold + increment``; the oracle asserts ``total <= BOT``
(2^16), so that sum is the one bound the port places on the knobs.  Both
CUDA kernels keep the cumulative table unpacked in u32 and take any pair
inside it (the JAX package's u16-packed kernels stop at 2^15).
"""

from __future__ import annotations

KNOB_LIMIT = 1 << 16   # threshold + increment <= BOT of the range coder


def encode_cap(n: int) -> int:
    """Row capacity of an encoded block of n symbols (tpuzip.codecs.ari)."""
    return 2 * n + 64


def check_knobs(increment: int, threshold: int) -> None:
    """Raise ValueError for a model the range coder cannot carry."""
    if not (0 <= increment and 1 <= threshold
            and threshold + increment <= KNOB_LIMIT):
        raise ValueError(
            f"ari knobs out of range: increment={increment}, "
            f"threshold={threshold} (need increment >= 0, threshold >= 1 "
            f"and threshold + increment <= {KNOB_LIMIT})")
