"""Hand-written CUDA kernels of the port, their wrappers and plain PyTorch
versions (tpuzip/kernels counterparts).  Each wrapper runs its plain
version on a CPU tensor and launches its kernel on a CUDA tensor."""
