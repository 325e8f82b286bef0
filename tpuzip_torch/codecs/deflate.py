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

tpuzip's device rule, the bytes of its compress_from_device, of its
``deflate`` and of its zlib wrapper, is ``deflate`` / ``deflate_batch``
here (tpuzip/codecs/deflate.py:464, :523): one dynamic block a row from a
greedy parse at max_chain 1, its code lengths in the oracle's
package-merge order (deflate_coder.deflate_xla_encode_batch).
``inflate`` / ``inflate_batch`` read any RFC 1951 stream and raise
ValueError where tpuzip's raise it (an empty, truncated or corrupt stream,
or one that decodes past out_n).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuzip_torch.device import resolve

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


def _batch(blocks, lengths, device):
    """blocks as a (B, n) u8 tensor (an array is uploaded to `device`) and
    lengths as (B,) i32 beside them."""
    if isinstance(blocks, np.ndarray):
        blocks = torch.from_numpy(np.require(blocks, np.uint8, "CW")).to(
            resolve(device))
    if not torch.is_tensor(blocks) or blocks.dim() != 2 or \
            blocks.dtype != torch.uint8:
        raise ValueError("blocks must be a (B, n) u8 tensor or array")
    lengths = (lengths if torch.is_tensor(lengths) else torch.from_numpy(
        np.asarray(lengths, np.int64).reshape(-1)))
    return blocks.contiguous(), lengths.to(blocks.device, torch.int32)


def deflate_batch(blocks, lengths, device="cuda"):
    """tpuzip's deflate_batch: (B, N) u8 + (B,) lengths -> (comp (B, 2N +
    2048) u8, zero past each stream, a view; comp_lens (B,) i32), on the
    blocks' device (an array is uploaded to `device`).  Each row is one
    dynamic block of tpuzip's device rule, a raw stream any zlib reads
    (wbits -15)."""
    from tpuzip_torch.kernels import deflate_coder

    blocks, lengths = _batch(blocks, lengths, device)
    comp, clens = deflate_coder.deflate_xla_encode_batch(blocks, lengths)
    # no stream passes 2N + 2048 bytes: 15 bits a literal, 48 a match of 3
    # bytes or more, and a header of at most 4,498 bits
    return comp[:, : decode_cap(blocks.shape[1])], clens


def deflate(data: bytes, n_static: int | None = None,
            device="cuda") -> bytes:
    """tpuzip's deflate: data as one dynamic block of its device rule, a row
    of n_static bytes (or max(len(data), 32)); a raw RFC 1951 stream."""
    n = n_static or max(len(data), 32)
    if len(data) > n:
        raise ValueError(f"{len(data)} bytes do not fit a row of {n}")
    row = np.zeros((1, n), np.uint8)
    row[0, : len(data)] = np.frombuffer(data, np.uint8)
    comp, clens = deflate_batch(row, [len(data)], device)
    return comp[0, : int(clens[0])].cpu().numpy().tobytes()


def inflate_batch(comp_rows, comp_lens, out_n: int, device="cuda"):
    """tpuzip's inflate_batch: each row's stream (its first comp_lens
    bytes) decoded -> (out (B, out_n) u8, olens (B,) i32) on the rows'
    device (an array is uploaded to `device`).  ValueError if a stream is
    empty, corrupt or decodes past out_n."""
    from tpuzip_torch.kernels import deflate_coder

    rows, lens = _batch(comp_rows, comp_lens, device)
    if bool((lens <= 0).any()):
        raise ValueError("an empty DEFLATE stream in the batch")
    out, status = deflate_coder.inflate_batch(rows, lens, max(out_n, 1))
    if bool(((status < 0) | (status > out_n)).any()):
        raise ValueError("corrupt DEFLATE symbol stream in batch")
    return out[:, :out_n], status.to(torch.int32)


def inflate(data: bytes, out_n: int, device="cuda") -> bytes:
    """tpuzip's inflate: a raw RFC 1951 stream decoded; ValueError if it is
    empty, corrupt or decodes past out_n bytes."""
    if not data:
        raise ValueError("truncated DEFLATE stream")
    out, olens = inflate_batch(np.frombuffer(data, np.uint8)[None],
                               [len(data)], out_n, device)
    return out[0, : int(olens[0])].cpu().numpy().tobytes()
