"""Device policy and the CUDA kernel build."""
