"""Command-line front ends of the port."""
