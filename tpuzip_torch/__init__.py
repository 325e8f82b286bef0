"""tpuzip_torch — the PyTorch/CUDA port of tpuzip.

A second package beside ``tpuzip``: the same tpz container, byte for byte,
produced and read with PyTorch on an NVIDIA GPU, where every Pallas kernel
of tpuzip becomes a CUDA kernel written for Hopper (``sm_90a``) under
``tpuzip_torch/csrc``.  ``tpuzip`` stays the reference the port is tested
against; the port imports nothing of it and keeps its own copies of what
it needs (``runtime.errors``, ``core.blocks``, ``core.config``, ``oracle``).

Ported so far: every codec of the tpz container.  The container round
trip of the lz4 codec (LZ4 blocks, tpuzip's default;
``config.codec.lz4.max_chain > 1`` runs tpuzip's chained encoder), of the
rle codec, of the lz4p codec (LZ4's parse in u16 columns) and of the
deflate codec (raw RFC 1951 streams in dynamic, fixed or stored blocks,
``config.codec.deflate``; the inflate reads any RFC 1951 stream), and the
chunk-indexed one of the ari codec, of the bwt codec (BWT -> MTF -> ari,
with the segmented entropy stage of blocks above 1 MiB), of the bwtdc
codec (BWT -> DC -> ari) and of the bin and apm codecs (a binary adaptive
model over each block's bits, the apm one refined by an APM/SSE gate).
For data that lives on the device, ``compress_from_device`` and
``decompress(to_device=True)`` (deflate there is tpuzip's device rule,
as in ``codecs.deflate.deflate`` and the zlib wrapper ``codecs.zlib_``);
for large corpora, ``compress_corpus`` and ``decompress_corpus`` (the
TPZC container of superbatches, which ``decompress`` also reads).  The
LZ4 frame format (``codecs.lz4_frame``: frames liblz4 reads, with their
xxh32 checksums) and the streaming adapters of ``io`` behind ``open``:
LZ4 frame, zlib and framed ari, bwt, rle, mtf and dc writers and readers.
Not ported yet: tpuzip's CLI, ``metrics=``, ``decompress``'s
``config=``, ``run_job``, ``ZlibWriter(batch_blocks=1)`` and ``dist``;
they raise NotImplementedError naming their ROADMAP.md item where the
port has the entry point.

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


def decompress(container: bytes, device="cuda", to_device: bool = False):
    """Decode a tpz container, or a TPZC corpus container (see
    dist.runner.decompress, decompress_corpus).  to_device=True returns
    (blocks tensor on `device`, olens, orig_len) of a tpz container."""
    from tpuzip_torch.dist import runner

    if container[:4] == runner.MAGIC_CORPUS:
        if to_device:
            raise ValueError("a TPZC corpus container decodes to bytes; "
                             "to_device takes one tpz container")
        return runner.decompress_corpus(container, device=device)
    return runner.decompress(container, device=device, to_device=to_device)


def compress_corpus(data: bytes, codec: str = "lz4",
                    block_size: int = 1 << 16, superbatch: int = 8 << 20,
                    pipeline: int = 2, **kw) -> bytes:
    """Compress a large corpus as a TPZC sequence of superbatch containers
    on a `pipeline`-thread pool (see dist.runner.compress_corpus)."""
    from tpuzip_torch.dist import runner

    return runner.compress_corpus(data, codec=codec, block_size=block_size,
                                  superbatch=superbatch, pipeline=pipeline,
                                  **kw)


def decompress_corpus(blob: bytes, pipeline: int = 2,
                      device="cuda") -> bytes:
    """The inverse of compress_corpus."""
    from tpuzip_torch.dist import runner

    return runner.decompress_corpus(blob, pipeline=pipeline, device=device)


def compress_from_device(blocks, lengths, codec: str = "lz4", **kw) -> bytes:
    """Compress (B, n) u8 blocks that live on the device into a tpz
    container (see dist.runner.compress_from_device); the inbound half is
    ``decompress(..., to_device=True)``."""
    from tpuzip_torch.dist import runner

    return runner.compress_from_device(blocks, lengths, codec=codec, **kw)


def open(file, mode: str = "rb", format: str = "lz4f", **kw):  # noqa: A001
    """Streaming reader/writer over a binary file object (io.py): an LZ4
    frame ("lz4f", the default), zlib, or a framed block codec of
    io.STREAM_CODECS.  A writer takes its keywords (device= among them); a
    reader takes device= and, as tpuzip's, no other."""
    from tpuzip_torch import io as tio

    device = kw.get("device", "cuda")
    if format == "lz4f":
        return tio.Lz4FrameWriter(file, **kw) if "w" in mode \
            else tio.Lz4FrameReader(file, device=device)
    if format == "zlib":
        return tio.ZlibWriter(file, **kw) if "w" in mode \
            else tio.ZlibReader(file, device=device)
    if format in tio.STREAM_CODECS:
        return tio.CodecWriter(file, format, **kw) if "w" in mode \
            else tio.CodecReader(file, format, device=device)
    raise ValueError(f"unknown streaming format {format!r}")
