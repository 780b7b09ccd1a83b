"""Hand-written CUDA kernels, each with its plain PyTorch version."""
