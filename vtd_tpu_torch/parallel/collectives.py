"""Collectives of data-parallel training.

The reference trains one logical batch under GSPMD, so its BatchNorm
statistics and its losses are taken over the whole batch. The port runs
one process per rank, each with its slice of the batch; inside
:func:`data_group` the train-mode ``BatchNorm2d`` (``models/resnet.py``)
and the DB losses (``train/losses.py``) all-reduce their sums over the
group with :func:`all_reduce_sum`, so every rank computes the global
statistics and the global loss.

The gradient of such a loss: every rank holds the same loss, and the
backward of :func:`all_reduce_sum` sums what the ranks send back, so each
rank's parameter gradient is ``W`` times its own share of the global
gradient. :func:`average_gradients` (all-reduce, then divide by ``W``)
therefore gives every rank the global gradient exactly.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterable, Optional

import torch
import torch.distributed as dist

_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "vtd_data_group", default=None)


@contextlib.contextmanager
def data_group(group: Optional[dist.ProcessGroup]):
    """Within the block, BatchNorm in train mode and the DB losses reduce
    over ``group`` (None: the local batch, as on one card)."""
    token = _GROUP.set(group)
    try:
        yield group
    finally:
        _GROUP.reset(token)


def current_data_group() -> Optional[dist.ProcessGroup]:
    return _GROUP.get()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group forward; the backward sums the incoming
    gradients over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def average_gradients(params: Iterable[torch.nn.Parameter],
                      group: dist.ProcessGroup) -> None:
    """Replace every ``.grad`` by its mean over the group: one all-reduce
    a device of the gradients on it flattened together, the devices in the
    order their first gradient comes (a model split over a mesh row holds
    its shards on the row's devices; every rank's row splits the same
    tensors, so the flattened blocks match across ranks)."""
    by_device: dict = {}
    for p in params:
        if p.grad is not None:
            by_device.setdefault(p.grad.device, []).append(p.grad)
    for grads in by_device.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= dist.get_world_size(group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
