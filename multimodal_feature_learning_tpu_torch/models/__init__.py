"""Modules of the port; counterpart of the JAX ``models/``."""
