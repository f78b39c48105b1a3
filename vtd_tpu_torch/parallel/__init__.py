"""Multi-device execution of the port (counterpart of ``vtd_tpu/parallel``):
the data-axis split and model replicas (``sharding.py``), the
differentiable all-reduce and the data-parallel group of training
(``collectives.py``), and the two-stage runner (``pipeline.py``, imported
on its own)."""
from .sharding import (
    Replica,
    batch_sharding,
    infer_param_shardings,
    shard_variables,
)

__all__ = ["Replica", "batch_sharding", "infer_param_shardings",
           "shard_variables"]
