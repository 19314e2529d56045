"""Build support for the port's CUDA kernels."""
