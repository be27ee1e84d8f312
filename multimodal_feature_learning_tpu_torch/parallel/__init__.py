"""Data, tensor and token-axis parallelism over ``torch.distributed``;
counterpart of the JAX package's ``parallel/``."""

from .mesh import (  # noqa: F401
    make_mesh,
    maybe_initialize_distributed,
    replicate_params,
    shard_batch,
)
from .tp import shard_params_tp, tp_param_specs  # noqa: F401
