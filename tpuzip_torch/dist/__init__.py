"""The tpz container pipeline of the port (tpuzip/dist counterparts)."""
