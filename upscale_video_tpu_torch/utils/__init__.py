"""Host utilities: logging setup, stage timing, keep-awake (copies of
the JAX package's jax-free ``utils`` modules)."""
