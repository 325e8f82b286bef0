"""Pure-Python format oracles of the port: copies of the parts of
tpuzip/oracle that the port's checks read (ari with the bin/APM bit
models, mtf, bwt, dc, the LZ4 block codec and rle).  Nothing on the
port's compress or decompress path imports them; chip_smoke.py holds the
card's output against them."""
