"""Command-line entry points (tools/ of the JAX package)."""
