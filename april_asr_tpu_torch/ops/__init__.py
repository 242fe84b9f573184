"""Hand-written CUDA kernels for the port, each beside its plain PyTorch
version (the CPU path and the reference the kernel is held against)."""
