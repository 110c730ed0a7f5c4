"""Utilities: CUDA kernel build, weight conversion from JAX, reporting."""
