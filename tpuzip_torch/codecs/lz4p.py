"""lz4p (codec id 7): LZ4's parse serialised in columns, so that a block
decodes without a serial parse (tpuzip/codecs/lz4p.py is the format's
owner).

  [num_seqs S u32 LE][orig_len u32 LE]
  [lit_lens u16 LE x S][mlens u16 LE x S][offsets u16 LE x S]
  [literal bytes, concatenated]

Sequence t is lit_lens[t] literals, then a match of mlens[t] bytes
offsets[t] back (none where mlens[t] is 0).  tpuzip writes it two ways,
and the port writes each one's bytes (kernels/lz4p_coder.py):

  - compress: its C++ ``tpz_lz4p_encode`` (csrc/tpuzip_host.cpp:333),
    the parse of the single-probe C++ lz4 encoder at the config's
    hash_log (clamped as lz4's), max_chain ignored.  A run over 65535
    bytes is split into pieces of 65535: literals with mlen 0 and offset
    0, a match's tail with no literals and the same offset.  The last
    sequence is the last literals (an empty block: S = 1, (0, 0, 0)).
  - compress_from_device and compress(device_encode=True): its XLA
    ``encode`` (:50), the parse of its device lz4 encoder at hash_log 15,
    the columns unsplit.  Its u16 columns cannot hold a run of 65536 (a
    64 KiB block without a match), which tpuzip writes as 0, so its
    container does not decode; the port refuses such rows (ValueError)
    and takes blocks of at most 65536 bytes, as tpuzip asserts.
"""

from __future__ import annotations

HDR = 8              # [S u32][orig_len u32]
XLA_MAX_BLOCK = 1 << 16   # tpuzip's XLA encoder's rows, at most


def encode_cap(n: int) -> int:
    """The largest payload a block of n bytes may declare, and the row
    capacity of the encoders (tpuzip's lz4p.encode_cap)."""
    return HDR + 6 * (n // 4 + 2) + n + 64
