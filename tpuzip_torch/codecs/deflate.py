"""The deflate codec (codec id 5): one raw RFC 1951 stream a block.

tpuzip's ``compress`` writes the bytes of its C++ encoder ``tpz_deflate``
(csrc/tpuzip_host.cpp:1314-1583) wherever its host coder loads, in each
of the three block types that ``config.codec.deflate.mode`` picks:

  dynamic  a hash-chain LZ77 parse (3-byte hash of 15 bits, max_chain
           links, 32 KiB window, lazy matching) coded with package-merge
           Huffman codes of at most 15 bits, in one final block;
  fixed    the same parse coded with the RFC's fixed codes;
  stored   blocks of at most 65,535 raw bytes, BFINAL on the last (an
           empty block is one empty stored block, 5 bytes).

kernels/deflate_coder.py holds the kernels that write those bytes and
their plain versions, and the inflate that reads any RFC 1951 stream.
"""

from __future__ import annotations

MODES = {"dynamic": 0, "fixed": 1, "stored": 2}


def mode_id(mode: str) -> int:
    """The encoder's block type of config.codec.deflate.mode; ValueError
    on any other mode, as tpuzip's runner raises."""
    if mode not in MODES:
        raise ValueError(f"deflate.mode {mode!r}")
    return MODES[mode]


def encode_cap(n: int) -> int:
    """Row capacity of the encoder on blocks of n bytes (tpuzip's batch
    capacity, tpuzip/runtime/native.py:549).  A dynamic block may pass
    its raw bytes: 64 KiB of random bytes take 65,610."""
    return 2 * n + 4096


def decode_cap(n: int) -> int:
    """The largest payload a block of n bytes may declare (tpuzip's bound
    in its decompress, tpuzip/dist/runner.py:638)."""
    return 2 * n + 2048
