"""Scoring of dense captions; the port's copy of the JAX package's
``evaluation/`` (pure Python and numpy)."""

from .anet_eval import ANETCaptionsEvaluator, run_eval  # noqa: F401
