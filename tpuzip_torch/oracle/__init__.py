"""Pure-Python format oracles of the port: copies of the parts of
tpuzip/oracle that the port reads (ari with the bin/APM bit models, mtf,
bwt, dc, the LZ4 block codec, rle and Adler-32).  The compress and
decompress paths import only adler (its combine folds the corpus
checksum from parts); chip_smoke.py holds the card's output against the
others."""
