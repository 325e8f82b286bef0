"""Pure-Python format oracles of the port: copies of the parts of
tpuzip/oracle that the port reads (ari with the bin/APM bit models, mtf,
bwt, dc, the LZ4 block and frame codec with xxh32, rle, Adler-32 and the
DEFLATE decoder with its tables).  The compress and decompress paths
import only adler (its combine folds the corpus checksum from parts) and
deflate (its length and distance tables); the LZ4 frame and the streaming
adapters import lz4's frame constants and xxh32 for the 2-byte header
check.  chip_smoke.py holds the card's output against the others."""
