"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
their launch geometry. Nothing here builds or loads a kernel at import."""
