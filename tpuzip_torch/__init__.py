"""tpuzip_torch — the PyTorch/CUDA port of tpuzip.

A second package beside ``tpuzip``: the same tpz container, byte for byte,
produced and read with PyTorch on an NVIDIA GPU, where every Pallas kernel
of tpuzip becomes a CUDA kernel written for Hopper (``sm_90a``) under
``tpuzip_torch/csrc``.  ``tpuzip`` stays the reference the port is tested
against; the port imports nothing of it and keeps its own copies of what
it needs (``runtime.errors``, ``core.blocks``, ``core.config``, ``oracle``).

Ported so far: the container round trip of the lz4 codec (LZ4 blocks,
tpuzip's default) and of the rle codec, and the chunk-indexed one of the
ari codec, of the bwt codec (BWT -> MTF -> ari, with the segmented entropy
stage of blocks above 1 MiB), of the bwtdc codec (BWT -> DC -> ari) and of
the bin and apm codecs (a binary adaptive model over each block's bits,
the apm one refined by an APM/SSE gate).  The other codecs and entry points raise
NotImplementedError naming the ROADMAP.md item that ports them.

``device="cuda"`` (the default) runs the kernels and raises when there is
no usable GPU; ``device="cpu"`` runs their plain PyTorch versions.
"""

__version__ = "0.1.0"

from tpuzip_torch.core.config import CodecConfig, Config  # noqa: F401


def compress(data: bytes, codec: str = "lz4", block_size: int = 1 << 16,
             device="cuda", config=None,
             block_checksums: bool = False) -> bytes:
    """Compress a corpus into a tpz container (see dist.runner.compress).

    The defaults mirror ``tpuzip.compress``: the lz4 codec, 64 KiB blocks
    for every codec (block_size=None takes the runner's per-codec default
    from the config, 1 MiB for bwt and bwtdc)."""
    from tpuzip_torch.dist import runner

    return runner.compress(data, codec=codec, block_size=block_size,
                           device=device, config=config,
                           block_checksums=block_checksums)


def decompress(container: bytes, device="cuda") -> bytes:
    """Decode a tpz container (see dist.runner.decompress)."""
    from tpuzip_torch.dist import runner

    return runner.decompress(container, device=device)


def _not_ported(what: str, item: int):
    from tpuzip_torch.dist import runner

    raise runner.not_ported(what, item)


def compress_corpus(data: bytes, codec: str = "lz4", **kw) -> bytes:
    _not_ported("compress_corpus", 11)


def decompress_corpus(blob: bytes, **kw) -> bytes:
    _not_ported("decompress_corpus", 11)


def compress_from_device(blocks, lengths, codec: str = "lz4", **kw) -> bytes:
    _not_ported("compress_from_device", 10)


def open(file, mode: str = "rb", format: str = "lz4f", **kw):  # noqa: A001
    _not_ported("open (the streaming adapters)", 15)
