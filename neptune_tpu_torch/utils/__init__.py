"""Utilities: option parsing (copied from the JAX package) and tensor algebra."""
