"""Tensor operations of the port; counterpart of the JAX ``ops/``."""
