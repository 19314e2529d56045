"""Lowering and execution of compiled targets on torch tensors."""
