"""Kernels (each beside its plain PyTorch version) and retrieval ops."""
