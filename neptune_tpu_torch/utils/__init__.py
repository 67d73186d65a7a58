"""Utilities: option parsing (copied from the JAX package), tensor algebra,
checkpoints, the long-simulation driver and profiling."""
