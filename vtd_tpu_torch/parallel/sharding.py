"""Sharding rules of the port (counterpart of
``vtd_tpu/parallel/sharding.py``).

The reference annotates the batch and the parameters with
``NamedSharding``s and lets GSPMD partition one program. The port splits
instead: a batch into contiguous row blocks, one per data-axis row
(:func:`batch_sharding`), and the models into one copy per row
(:func:`shard_variables`), each driven by a :class:`Replica` (a thread
of its own and, on the card, a CUDA stream of its own). Frames are
independent, so inference needs no collective; training's collectives
are in ``collectives.py``. Over the model axis each row's copy is split
over the row's devices (``tensor_parallel.py``) by the reference's rule,
:func:`param_spec` on each tensor in the reference's layout
(:func:`split_dim`, :func:`infer_param_shardings`).
"""
from __future__ import annotations

import contextlib
import math
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from ..core.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def _n_data(mesh: Union[Mesh, int]) -> int:
    return mesh.shape[DATA_AXIS] if isinstance(mesh, Mesh) else int(mesh)


def batch_sharding(batch, mesh: Union[Mesh, int]) -> List[Any]:
    """The row blocks of ``batch`` (a numpy array or a tensor) over the
    data axis, in order; raises ``ValueError`` unless they are equal."""
    n = _n_data(mesh)
    b = len(batch)
    if b % n:
        raise ValueError(
            f"batch of {b} not divisible by the mesh data axis ({n})")
    rows = b // n
    return [batch[i * rows:(i + 1) * rows] for i in range(n)]


def shard_variables(model, devices: Union[Mesh, Sequence[torch.device]]
                    ) -> List[Any]:
    """One copy of ``model`` per data-axis row (or per device of a list):
    ``model.replica(row)`` for the runtime's detector and recognizers. On
    a mesh whose model axis has more than one entry each copy is split
    over its row (``tensor_parallel.tensor_parallel_``). Otherwise the
    first entry takes ``model`` itself when it already lies on that
    device; every other entry gets its own copy, on a repeated device
    too."""
    if isinstance(devices, Mesh):
        if devices.shape[MODEL_AXIS] > 1:
            return [model.replica(devices.row(i))
                    for i in range(devices.shape[DATA_AXIS])]
        devices = devices.data_devices()
    return [model if i == 0 and d == model.device else model.replica(d)
            for i, d in enumerate(devices)]


MIN_SIZE = 256


def param_spec(shape: Sequence[int], n_model: int,
               min_size: int = MIN_SIZE) -> Optional[int]:
    """The reference's rule (``vtd_tpu/parallel/sharding.py:_param_spec``)
    on a tensor of ``shape`` in the reference's layout: the dimension split
    over a model axis of ``n_model`` entries (always the last), or None
    (replicated). A split needs the last dimension to divide by
    ``n_model`` and to be at least ``min_size``, and the tensor to hold at
    least ``min_size**2`` elements."""
    if len(shape) == 0:
        return None
    last = shape[-1]
    if (n_model > 1 and last % n_model == 0 and last >= min_size
            and math.prod(shape) >= min_size * min_size):
        return len(shape) - 1
    return None


def _ref_last_dim(module: nn.Module, name: str, t: torch.Tensor) -> int:
    """The dimension of the port's tensor that the reference's layout puts
    last: the output channels of a ``Conv2d`` (OIHW against HWIO) and of a
    ``Linear`` ([out, in] against Dense's [in, out]); the last dimension
    of everything else (an ``Embedding``'s features, an LSTM weight's
    input, a bare parameter's own layout)."""
    if name == "weight" and isinstance(module, (nn.Conv2d, nn.Linear)):
        return 0
    return t.dim() - 1


def split_dim(module: nn.Module, name: str, t: torch.Tensor, n_model: int,
              min_size: int = MIN_SIZE) -> Optional[int]:
    """The dimension of ``module``'s tensor ``name`` (``t``) that the rule
    splits over ``n_model`` entries, in the port's layout, or None."""
    if t.dim() == 0:
        return None
    d = _ref_last_dim(module, name, t)
    ref_shape = [s for i, s in enumerate(t.shape) if i != d] + [t.shape[d]]
    return None if param_spec(ref_shape, n_model, min_size) is None else d


def infer_param_shardings(model: nn.Module, mesh: Union[Mesh, int],
                          min_size: int = MIN_SIZE
                          ) -> Dict[str, Optional[int]]:
    """For every name of an unsplit ``model``'s state dict: the dimension
    of the port's tensor that the model axis of ``mesh`` (a ``Mesh`` or
    its ``n_model``) splits, or None where it is replicated. Shapes only:
    a model on the ``meta`` device will do."""
    n_model = mesh.shape[MODEL_AXIS] if isinstance(mesh, Mesh) else int(mesh)
    out = {}
    for key, t in model.state_dict(keep_vars=True).items():
        owner, _, local = key.rpartition(".")
        out[key] = split_dim(model.get_submodule(owner), local, t, n_model,
                             min_size)
    return out


def _bind(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)


class Replica:
    """One data-axis row at run time: its ``device`` (the row's first
    entry), its own copies of the models (``detector``, ``recognizer``;
    either may be None; split over the row on a model axis), one
    persistent thread and, on the card, its own CUDA stream. Work handed
    to :meth:`submit` runs in that thread, in inference mode, with the
    replica's device and stream current, in the order it was submitted.
    """

    def __init__(self, device: torch.device, detector=None, recognizer=None):
        self.device = device
        self.detector = detector
        self.recognizer = recognizer
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        # the initializer takes the device, not a bound method: a worker
        # thread holding the replica would keep its executor alive forever
        self._pool = ThreadPoolExecutor(
            1, thread_name_prefix=f"replica-{device}", initializer=_bind,
            initargs=(device,))

    def submit(self, fn: Callable[..., Any], *args) -> Future:
        """``fn(self, *args)`` in the replica's thread."""
        return self._pool.submit(self._run, fn, args)

    def _run(self, fn, args):
        ctx = (torch.cuda.stream(self.stream) if self.stream is not None
               else contextlib.nullcontext())
        with torch.inference_mode(), ctx:
            return fn(self, *args)

    def close(self) -> None:
        """Finish the queued work and end the thread."""
        self._pool.shutdown(wait=True)


def gather(parts: Sequence[Any]) -> List[Any]:
    """The results of a list of Futures (or plain values), in order."""
    return [p.result() if isinstance(p, Future) else p for p in parts]


def row_blocks(b: int, n_from: int, n_to: int, j: int):
    """Which rows of which source blocks make up target block ``j`` when
    ``b`` rows split into ``n_from`` blocks are regrouped into ``n_to``:
    a list of (source block, first row, last row + 1) in source-block
    coordinates, in row order."""
    src, dst = b // n_from, b // n_to
    lo, hi = j * dst, (j + 1) * dst
    return [(i, max(lo, i * src) - i * src, min(hi, (i + 1) * src) - i * src)
            for i in range(n_from) if i * src < hi and (i + 1) * src > lo]
