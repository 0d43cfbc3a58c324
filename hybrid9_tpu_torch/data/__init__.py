"""Synthetic numpy generators shared with the JAX package."""
