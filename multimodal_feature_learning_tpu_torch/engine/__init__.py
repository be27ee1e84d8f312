"""Training engine of the port; counterpart of the JAX ``engine/``."""
