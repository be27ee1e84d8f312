"""Host-side data helpers of the port; counterpart of the JAX ``data/``."""
