"""End-to-end workflows over the port's chain engine."""
