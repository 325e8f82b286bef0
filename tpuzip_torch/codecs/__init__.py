"""Codec-level helpers of the port (tpuzip/codecs counterparts)."""
