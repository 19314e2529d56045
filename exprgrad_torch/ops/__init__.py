"""Kernels and extern implementations of the port."""
