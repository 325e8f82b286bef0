"""Move-to-front of a block or a batch of blocks: the counterpart of
tpuzip/codecs/mtf.py (``encode`` :15, ``decode`` :32 and their vmapped
batches), over kernels/mtf_scan.py (csrc/mtf.cu on a CUDA tensor, its
plain version on a CPU one).  A row's first ``length`` bytes are coded
from the identity rank table; the output is 0 from there on.
"""

from __future__ import annotations

import torch

from tpuzip_torch.kernels import mtf_scan


def _lengths(lengths, blocks: torch.Tensor) -> torch.Tensor:
    lengths = (lengths if torch.is_tensor(lengths)
               else torch.as_tensor(lengths).reshape(-1))
    return lengths.to(blocks.device, torch.int32).contiguous()


def encode_batch(blocks: torch.Tensor, lengths) -> torch.Tensor:
    """(B, N) u8 blocks and their lengths -> (B, N) u8 ranks."""
    return mtf_scan.mtf_batch(blocks.contiguous(), _lengths(lengths, blocks))


def decode_batch(blocks: torch.Tensor, lengths) -> torch.Tensor:
    """(B, N) u8 ranks and their lengths -> (B, N) u8 symbols."""
    return mtf_scan.mtf_batch(blocks.contiguous(), _lengths(lengths, blocks),
                              decode=True)


def encode(block: torch.Tensor, length) -> torch.Tensor:
    """One (N,) u8 block's first `length` bytes -> (N,) u8 ranks."""
    return encode_batch(block[None], [int(length)])[0]


def decode(block: torch.Tensor, length) -> torch.Tensor:
    """One (N,) u8 block of ranks -> (N,) u8 symbols."""
    return decode_batch(block[None], [int(length)])[0]
