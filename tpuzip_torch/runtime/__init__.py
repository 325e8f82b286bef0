"""Runtime helpers of the port (tpuzip/runtime counterparts)."""
