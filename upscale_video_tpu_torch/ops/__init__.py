"""Tensor ops and the kernel wrappers (each beside its plain PyTorch version)."""
