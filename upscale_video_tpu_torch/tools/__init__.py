"""Benchmarks of the port's conv-body kernels (run with ``python -m``)."""
