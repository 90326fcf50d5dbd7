"""Hand-written CUDA kernels and their build."""
