"""Data-axis rules of the port (counterpart of
``vtd_tpu/parallel/sharding.py``).

The reference annotates the batch and the parameters with
``NamedSharding``s and lets GSPMD partition one program. The port splits
instead: a batch into contiguous row blocks, one per data-axis entry
(:func:`batch_sharding`), and the models into one copy per entry
(:func:`shard_variables`), each driven by a :class:`Replica` (a thread
of its own and, on the card, a CUDA stream of its own). Frames are
independent, so inference needs no collective; training's collectives
are in ``collectives.py``. Sharding wide kernels over the model axis
(:func:`infer_param_shardings`) is not ported yet.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Sequence, Union

import torch

from ..core.mesh import DATA_AXIS, MODEL_AXIS_NOT_PORTED, Mesh


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
    """One copy of ``model`` per data-axis entry (or per device of a
    list): ``model.replica(device)`` for the runtime's detector and
    recognizers. The first entry takes ``model`` itself when it already
    lies on that device; every other entry gets its own copy, on a
    repeated device too."""
    if isinstance(devices, Mesh):
        devices = devices.data_devices()
    return [model if i == 0 and d == model.device else model.replica(d)
            for i, d in enumerate(devices)]


def infer_param_shardings(variables, mesh: Mesh, min_size: int = 256):
    """Model-axis shardings of wide kernels: not ported yet."""
    raise NotImplementedError(MODEL_AXIS_NOT_PORTED)


def _bind(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)


class Replica:
    """One data-axis entry at run time: its ``device``, its own copies of
    the models (``detector``, ``recognizer``; either may be None), one
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
