"""Error taxonomy of the port: a copy of tpuzip/runtime/errors.py, with the
same class names and hierarchy, so both packages raise the same classes on
the same corrupt containers.  TpzError derives from ValueError."""

from __future__ import annotations


class TpzError(ValueError):
    """Base class for all framework errors."""


class HeaderError(TpzError):
    """Bad magic / version / descriptor (lz4 frame, zlib CMF/FLG, tpz)."""


class BlockLengthError(TpzError):
    """Declared block length inconsistent with stream contents."""


class ChecksumError(TpzError):
    """Adler-32 / xxHash32 mismatch."""


class CodeSetError(TpzError):
    """Malformed Huffman code set (over-subscribed / incomplete)."""


class CorruptStreamError(TpzError):
    """A decoder flagged a poisoned block (bad offset, overrun...)."""

    def __init__(self, block_ids):
        self.block_ids = list(block_ids)
        super().__init__(f"corrupt blocks: {self.block_ids[:8]}"
                         + ("..." if len(self.block_ids) > 8 else ""))


class RemoteDecodeError(TpzError):
    """A peer host failed its local block range in a distributed decode
    (the failure rode the checksum allgather as a sentinel, so every host
    raises instead of deadlocking in the collective)."""

    def __init__(self, host_ids):
        self.host_ids = list(host_ids)
        super().__init__(
            f"distributed decode failed on host(s) {self.host_ids}")
