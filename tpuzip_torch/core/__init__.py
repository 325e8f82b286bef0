"""Core helpers of the port (tpuzip/core counterparts)."""
