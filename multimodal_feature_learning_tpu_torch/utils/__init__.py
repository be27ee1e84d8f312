"""Helpers of the port; counterpart of the JAX ``utils/``."""
