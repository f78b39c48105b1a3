"""Device mesh and process groups (port of ``vtd_tpu/core/mesh.py``).

The reference is single-controller: one process drives every chip of a
host through a ``jax.sharding.Mesh`` and ``jax.distributed`` joins hosts.
The port keeps its names and uses PyTorch's own idiom underneath:

  * a :class:`Mesh` is an ``(n_data, n_model)`` array of ``torch.device``.
    Inference runs one replica of the models per data-axis entry, each in
    its own thread on its own CUDA stream, all in one process
    (``runtime/pipeline.py``). Entries may repeat: two replicas on one
    card, or a mesh of ``cpu`` entries in the tests.
  * training runs one process per data-axis entry (a rank), joined by
    ``torch.distributed``: NCCL on the card, gloo on the CPU
    (:func:`init_distributed`, :func:`spawn_ranks`).
  * the ``n_model`` entries of a data-axis row (:meth:`Mesh.row`) are the
    devices that row's wide layers are split over, all inside its one
    replica or rank (``parallel/tensor_parallel.py``): the activations
    live on the row's first entry, the lead. A rank's row is given by
    :func:`rank_row`. Entries may repeat here too (``[cuda:0, cuda:0]``
    on one card).
"""
from __future__ import annotations

import datetime
import math
import os
import queue as _queue
import socket
import time
import traceback
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# How long a rank waits for the others to join a group, and for any one
# collective, before it raises instead of hanging.
GROUP_TIMEOUT_S = 600.0


class Mesh:
    """``devices``: an ``(n_data, n_model)`` numpy array of
    ``torch.device``; ``shape``: ``{"data": n_data, "model": n_model}``."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"mesh devices must be 2-d, got {devices.shape}")
        self.devices = devices
        self.shape = {DATA_AXIS: devices.shape[0], MODEL_AXIS: devices.shape[1]}

    def data_devices(self) -> List[torch.device]:
        """The first device of each data-axis row, in row order."""
        return [self.devices[i, 0] for i in range(self.devices.shape[0])]

    def row(self, i: int) -> List[torch.device]:
        """The model-axis devices of data-axis row ``i``, lead first."""
        return list(self.devices[i])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flatten()]})")


def visible_devices(device: str = "cuda") -> List[torch.device]:
    """Every visible CUDA device, or one CPU entry for ``device="cpu"``.
    Raises without CUDA unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_devices(n: int, device: str = "cuda") -> List[torch.device]:
    """This process's first ``n`` CUDA devices, or ``n`` entries of the
    CPU for ``device="cpu"``: what ``process --data-parallel N``, serving's
    ``data_parallel_chips`` and a worker's mesh are built over."""
    found = visible_devices(device)
    if found[0].type == "cpu":
        return found * n
    if n > len(found):
        raise ValueError(f"mesh {n}x1 != {len(found)} devices")
    return found[:n]


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[Any]] = None,
    device: str = "cuda",
) -> Mesh:
    """Build a (data, model) mesh. Without ``devices``: every visible CUDA
    device, or for ``device="cpu"`` ``n_data * n_model`` entries of the
    CPU. With no ``n_data``, every device goes to the data axis."""
    if devices is None:
        devices = visible_devices(device)
        if devices[0].type == "cpu":
            devices = devices * ((n_data or 1) * n_model)
    devices = [resolve_device(d) for d in devices]
    n_total = len(devices)
    if n_data is None:
        n_data = n_total // n_model
    if n_data * n_model != n_total:
        raise ValueError(f"mesh {n_data}x{n_model} != {n_total} devices")
    arr = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices):
        arr[i // n_model, i % n_model] = d
    return Mesh(arr)


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)


_ACTIVE_MESH: Optional[Mesh] = None


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


@contextmanager
def active_mesh(mesh: Mesh):
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def local_batch_slice(
    global_batch: int, mesh: Mesh, rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> Tuple[int, int]:
    """(start, size) of this process's contiguous slice of a batch split
    over the data axis. The data rows are shared out evenly over the
    processes of the group in rank order (one row each when there is one
    rank per entry, as in training); a process outside any group owns
    every row. ``rank`` / ``world_size`` default to the process group's."""
    n_data = mesh.shape[DATA_AXIS]
    if global_batch % n_data:
        raise ValueError(
            f"batch {global_batch} not divisible by the mesh data axis "
            f"({n_data})")
    if world_size is None:
        dist = torch.distributed
        inited = dist.is_available() and dist.is_initialized()
        world_size = dist.get_world_size() if inited else 1
        rank = dist.get_rank() if inited else 0
    if n_data % world_size:
        raise ValueError(
            f"{n_data} data rows cannot be shared out over {world_size} "
            "processes")
    rows = n_data // world_size
    per_row = global_batch // n_data
    return rank * rows * per_row, rows * per_row


def rank_row(
    mesh: Mesh, rank: Optional[int] = None, world_size: Optional[int] = None,
) -> List[torch.device]:
    """The mesh row of this process: the first of the data rows that
    :func:`local_batch_slice` gives it (its one row when there is one rank
    per row, as in training). ``rank`` / ``world_size`` default to the
    process group's (row 0 outside any group)."""
    n_data = mesh.shape[DATA_AXIS]
    start, _ = local_batch_slice(n_data, mesh, rank, world_size)
    return mesh.row(start)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join this process to a ``torch.distributed`` group, the
    counterpart of the reference's ``jax.distributed.initialize``.

    Arguments default to ``VTD_COORDINATOR_ADDRESS`` (``host:port``),
    ``VTD_NUM_PROCESSES`` and ``VTD_PROCESS_ID``. Returns False, doing
    nothing, when neither an address nor a count is given (one process);
    True once a group exists (idempotent). The backend is NCCL for
    ``device="cuda"`` and gloo for ``"cpu"`` unless ``backend`` names one;
    on the card the process takes CUDA device ``process_id % count`` as its
    own. ``GROUP_TIMEOUT_S`` bounds the join and every collective.
    """
    dist = torch.distributed
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "VTD_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("VTD_NUM_PROCESSES"):
        num_processes = int(os.environ["VTD_NUM_PROCESSES"])
    if process_id is None and os.environ.get("VTD_PROCESS_ID"):
        process_id = int(os.environ["VTD_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None:
        raise ValueError("VTD_NUM_PROCESSES set without "
                         "VTD_COORDINATOR_ADDRESS (host:port)")
    if num_processes is None:
        raise ValueError("VTD_COORDINATOR_ADDRESS set without "
                         "VTD_NUM_PROCESSES")
    if process_id is None:
        if num_processes != 1:
            raise ValueError("VTD_PROCESS_ID is needed for more than one "
                             "process")
        process_id = 0
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend or _backend(dev),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    return True


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, address, device, backend, target, args,
               results):
    """One spawned rank: join the group, run ``target(rank, *args)`` and
    post (rank, ok, result or traceback); the group is always left."""
    try:
        init_distributed(address, world_size, rank, device=device,
                         backend=backend)
        results.put((rank, True, target(rank, *args)))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn_ranks(
    target: Callable[..., Any],
    args: tuple,
    world_size: int,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> List[Any]:
    """Run ``target(rank, *args)`` in ``world_size`` spawned processes
    joined by a group on a free localhost port; returns every rank's
    result in rank order. ``target`` and ``args`` must pickle (settings do
    not cross ``spawn``: pass them in ``args``).

    A rank that raises, or dies without a result, fails the run at once:
    the others are terminated rather than left waiting in a collective,
    and a ``RuntimeError`` carries the rank's traceback. Every process is
    joined before this returns or raises."""
    import torch.multiprocessing as mp

    resolve_device(device)  # no spawned CPU run when CUDA was asked for
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [
        ctx.Process(target=_rank_main, daemon=True, args=(
            r, world_size, address, device, backend, target, args,
            results))
        for r in range(world_size)
    ]
    out: Dict[int, Any] = {}
    failure = None
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(out) < world_size and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()]
                if dead:
                    # a result may still be in the pipe behind the exit
                    time.sleep(0.5)
                    while not results.empty():
                        rank, ok, value = results.get()
                        if ok:
                            out[rank] = value
                        else:
                            failure = f"rank {rank} failed:\n{value}"
                    dead = [r for r in dead if r not in out]
                    if dead and failure is None:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in started:
            if p.is_alive() and (failure is not None or len(out) < world_size):
                p.terminate()
        for p in started:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]
