"""Multi-device execution of the port (counterpart of ``vtd_tpu/parallel``):
the data-axis split, model replicas and the model-axis rule
(``sharding.py``), layers split over a mesh row (``tensor_parallel.py``),
the differentiable all-reduce and the data-parallel group of training
(``collectives.py``), and the two-stage runner (``pipeline.py``, imported
on its own)."""
from .sharding import (
    Replica,
    batch_sharding,
    infer_param_shardings,
    param_spec,
    shard_variables,
)
from .tensor_parallel import (
    ColumnParallel,
    GatheredLSTM,
    full_state_dict,
    n_split,
    tensor_parallel_,
)

__all__ = ["ColumnParallel", "GatheredLSTM", "Replica", "batch_sharding",
           "full_state_dict", "infer_param_shardings", "n_split",
           "param_spec", "shard_variables", "tensor_parallel_"]
