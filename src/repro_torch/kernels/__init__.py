"""Hand-written CUDA kernels for ⊎ and their dispatch (see scatter_ops)."""
