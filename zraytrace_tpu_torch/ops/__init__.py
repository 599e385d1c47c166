"""Hand-written CUDA kernels, their builder and their PyTorch wrappers."""
