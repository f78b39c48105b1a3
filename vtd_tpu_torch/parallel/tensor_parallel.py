"""Tensor parallelism over a mesh row: the model axis (counterpart of the
model-axis half of ``vtd_tpu/parallel/sharding.py``).

The reference puts a ``NamedSharding`` split on the model axis on every
wide kernel and lets GSPMD partition one program and insert the
collectives. The port splits the layers themselves over the devices of one
mesh row (``core.mesh.Mesh.row``), all inside one replica or rank:

  * which tensors are split is the reference's rule
    (``sharding.param_spec``), applied to each tensor in the reference's
    layout (``sharding.split_dim``): a convolution's or a linear's output
    channels, an embedding's feature dimension, an LSTM weight's input
    dimension (the reference keeps torch's ``[4H, in]``), a bare
    parameter's last dimension;
  * the activations live on the row's first entry (the lead), where every
    layer that is not split runs once;
  * a split ``Conv2d`` / ``Linear`` / ``Embedding`` is column-parallel
    (:class:`ColumnParallel`): each entry holds its slice of the output
    channels, takes a copy of the input, computes its slice and the slices
    are concatenated in order on the lead. On the card in inference every
    entry but the lead computes on a CUDA stream of its own, ordered by
    stream waits, with ``record_stream`` for the tensors that cross
    streams. With autograd on (training) the same copies and ``cat`` run
    on the caller's stream and give the backward: the sum of the entries'
    input gradients on the lead and the split of the output gradient. No
    collective is written by hand;
  * a split ``nn.LSTM`` (:class:`GatheredLSTM`) and a split bare parameter
    (:class:`GatherShards`, a parametrization) hold their shards where the
    rule puts them and are gathered on the lead where they are used: a
    contraction split inside the recurrence would need an all-reduce at
    every time step. The rule fixes where the weights live; GSPMD too is
    free to gather them.

Biases and the other 1-D tensors stay whole on the lead (the rule does not
split them); a split layer slices its bias where it uses it. A split
model's ``state_dict()`` has the unsplit model's keys and full shapes, and
a full state dict loads into it, so checkpoints cross between split and
unsplit models unchanged (:func:`full_state_dict`).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from ..core.device import resolve_device
from .sharding import MIN_SIZE, split_dim


# ---------------------------------------------------------------------------
# The row and its streams
# ---------------------------------------------------------------------------
class _Row:
    """The devices of one mesh row, lead first, and on the card a side
    stream for each entry but the lead, made at first use."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self._streams: Dict[tuple, torch.cuda.Stream] = {}

    def side_stream(self, i: int, device: torch.device) -> torch.cuda.Stream:
        key = (i, device)
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(device)
        return self._streams[key]


def _columns(row: _Row, x: torch.Tensor, devices: Sequence[torch.device],
             part: Callable[[int, torch.Tensor], torch.Tensor],
             dim: int) -> torch.Tensor:
    """``part(i, x on devices[i])`` for every entry, concatenated along
    ``dim`` on ``x``'s device. On the card without autograd every entry but
    the one on ``x``'s device at index 0 runs on its side stream, after the
    caller's stream has produced ``x``; the caller's stream waits for them
    before the ``cat``."""
    lead = x.device
    if lead.type != "cuda" or torch.is_grad_enabled():
        return torch.cat([part(i, x.to(d)).to(lead)
                          for i, d in enumerate(devices)], dim)
    cur = torch.cuda.current_stream(lead)
    outs, sides = [], []
    for i, d in enumerate(devices):
        if i == 0 and d == lead:
            outs.append(part(0, x))
            continue
        side = row.side_stream(i, d)
        side.wait_stream(cur)
        # a copy between cards runs on the source's current stream and
        # waits for the destination's, so both orders hold across cards
        with torch.cuda.stream(side):
            y = part(i, x.to(d, non_blocking=True)).to(lead,
                                                       non_blocking=True)
        if d == lead:
            x.record_stream(side)  # read on the side stream
            y.record_stream(cur)  # made there, read on the caller's
        sides.append(side)
        outs.append(y)
    for side in sides:
        cur.wait_stream(side)
    return torch.cat(outs, dim)


# ---------------------------------------------------------------------------
# Split layers
# ---------------------------------------------------------------------------
class _Sharded(nn.Module):
    """A layer whose tensors are held under their full names, each whole
    (on the lead) or split along a dimension into one shard an entry
    (``<name>_shard<i>``). ``state_dict()`` gives every tensor under its
    full name at its full shape (gathered on the lead), and loading a full
    state dict splits it again."""

    def __init__(self, row: _Row):
        super().__init__()
        self.row = row
        self._held: Dict[str, Optional[int]] = {}

    def _hold(self, name: str, t: Optional[torch.Tensor],
              dim: Optional[int]) -> None:
        self._held[name] = dim
        if dim is None:
            self.register_parameter(name, t)
            return
        parts = t.detach().chunk(len(self.row.devices), dim)
        for i, (d, part) in enumerate(zip(self.row.devices, parts)):
            self.register_parameter(f"{name}_shard{i}", nn.Parameter(
                part.to(d, copy=True), requires_grad=t.requires_grad))

    def shards(self, name: str) -> List[torch.Tensor]:
        return [getattr(self, f"{name}_shard{i}")
                for i in range(len(self.row.devices))]

    def full(self, name: str) -> Optional[torch.Tensor]:
        """Tensor ``name`` at its full shape, on the lead (a split one
        gathered)."""
        dim = self._held[name]
        if dim is None:
            return getattr(self, name)
        shards = self.shards(name)
        return torch.cat([s.to(shards[0].device) for s in shards], dim)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name in self._held:
            t = self.full(name)
            if t is not None:
                destination[prefix + name] = t if keep_vars else t.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        with torch.no_grad():
            for name, dim in self._held.items():
                key = prefix + name
                own = self.full(name)
                if own is None:
                    continue
                if key not in state_dict:
                    missing_keys.append(key)
                    continue
                value = state_dict[key]
                if tuple(value.shape) != tuple(own.shape):
                    error_msgs.append(
                        f"size mismatch for {key}: copying a param with "
                        f"shape {tuple(value.shape)}, the shape in the "
                        f"current model is {tuple(own.shape)}.")
                elif dim is None:
                    own.copy_(value)
                else:
                    parts = value.chunk(len(self.row.devices), dim)
                    for shard, part in zip(self.shards(name), parts):
                        shard.copy_(part)
        if strict:
            unexpected_keys.extend(
                k for k in state_dict if k.startswith(prefix)
                and k[len(prefix):] not in self._held)


class ColumnParallel(_Sharded):
    """A ``Conv2d``, ``Linear`` or ``Embedding`` split over a mesh row by
    output channels (features for the embedding): entry i holds slice i of
    the weight and computes slice i of the output from a copy of the
    input; the slices are concatenated on the input's device. The bias
    stays whole on the lead and is sliced where it is used.
    ``forward(x, dtype)`` casts the input, the weights and the bias to
    ``dtype`` at use, as the models' own ``F.linear`` / ``F.conv2d`` calls
    do (``models/trocr.py``)."""

    def __init__(self, layer: nn.Module, row: _Row):
        super().__init__(row)
        if isinstance(layer, nn.Conv2d):
            if layer.groups != 1 or layer.padding_mode != "zeros":
                raise ValueError("a grouped or padded-mode Conv2d is not "
                                 "split")
            self.kind, split, self.out_dim = "conv", 0, 1
            self.conv_args = (layer.stride, layer.padding, layer.dilation)
        elif isinstance(layer, nn.Linear):
            self.kind, split, self.out_dim = "linear", 0, -1
        elif isinstance(layer, nn.Embedding):
            self.kind, split, self.out_dim = "embedding", 1, -1
            self.padding_idx = layer.padding_idx
        else:
            raise TypeError(f"{type(layer).__name__} is not split by columns")
        self.columns = layer.weight.shape[split] // len(row.devices)
        self._hold("weight", layer.weight, split)
        self._hold("bias", getattr(layer, "bias", None), None)

    def _part(self, i: int, x: torch.Tensor, dtype) -> torch.Tensor:
        w = getattr(self, f"weight_shard{i}")
        if self.kind == "embedding":
            return F.embedding(x, w, self.padding_idx)
        b = self.bias
        if b is not None:
            b = b[i * self.columns:(i + 1) * self.columns].to(x.device)
        if dtype is not None:
            x, w = x.to(dtype), w.to(dtype)
            b = None if b is None else b.to(dtype)
        if self.kind == "conv":
            return F.conv2d(x, w, b, *self.conv_args)
        return F.linear(x, w, b)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        devices = [w.device for w in self.shards("weight")]
        return _columns(self.row, x, devices,
                        lambda i, xi: self._part(i, xi, dtype), self.out_dim)


class GatheredLSTM(_Sharded):
    """An ``nn.LSTM`` whose weights are held split by the rule (along
    their input dimension) and gathered on the input's device to run the
    whole recurrence there (cuDNN's on the card) with the unsplit layer's
    arithmetic."""

    def __init__(self, lstm: nn.LSTM, row: _Row,
                 dims: Dict[str, Optional[int]]):
        super().__init__(row)
        if lstm.proj_size:
            raise ValueError("an LSTM with projections is not split")
        self.hidden_size = lstm.hidden_size
        self.num_layers, self.bias = lstm.num_layers, lstm.bias
        self.batch_first, self.dropout = lstm.batch_first, lstm.dropout
        self.bidirectional = lstm.bidirectional
        self.weight_names = list(lstm._flat_weights_names)
        for name in self.weight_names:
            self._hold(name, getattr(lstm, name), dims.get(name))

    def forward(self, x: torch.Tensor):
        """A batch of sequences from a zero state -> (out, (h, c)), as
        ``nn.LSTM`` gives them."""
        lead = x.device
        weights = [self.full(n).to(lead) for n in self.weight_names]
        b = x.shape[0] if self.batch_first else x.shape[1]
        h0 = torch.zeros(self.num_layers * (2 if self.bidirectional else 1),
                         b, self.hidden_size, dtype=x.dtype, device=lead)
        out, h, c = torch._VF.lstm(
            x, (h0, h0), weights, self.bias, self.num_layers, float(self.dropout),
            self.training, self.bidirectional, self.batch_first)
        return out, (h, c)


class GatherShards(nn.Module):
    """A parametrization (``torch.nn.utils.parametrize``) that holds a bare
    parameter as one shard an entry along ``dim`` and gives the whole
    tensor, gathered on the first shard's device, where it is read."""

    def __init__(self, devices: Sequence[torch.device], dim: int):
        super().__init__()
        self.devices, self.dim = list(devices), dim

    def forward(self, *shards: torch.Tensor) -> torch.Tensor:
        lead = shards[0].device
        return torch.cat([s.to(lead) for s in shards], self.dim)

    def right_inverse(self, full: torch.Tensor):
        parts = full.chunk(len(self.devices), self.dim)
        return tuple(p.to(d, copy=True) for p, d in zip(parts, self.devices))


def _full_key_hook(module, state_dict, prefix, local_metadata, name):
    """State-dict post-hook of a module with a split bare parameter: its
    shards under the parameter's own key, gathered."""
    keys = [k for k in state_dict
            if k.startswith(f"{prefix}parametrizations.{name}.original")]
    if keys:
        state_dict[prefix + name] = getattr(module, name).detach()
        for k in keys:
            del state_dict[k]


def _split_key_hook(module, state_dict, prefix, local_metadata, strict,
                    missing_keys, unexpected_keys, error_msgs, name):
    """Load pre-hook of the same module: a full tensor under the
    parameter's key into the parametrization's shards."""
    key = prefix + name
    if key in state_dict:
        par = getattr(module.parametrizations, name)
        parts = par[0].right_inverse(state_dict.pop(key))
        for i, part in enumerate(parts):
            state_dict[f"{prefix}parametrizations.{name}.original{i}"] = part


def _split_parameter(owner: nn.Module, name: str, row: _Row,
                     dim: int) -> None:
    parametrize.register_parametrization(owner, name,
                                         GatherShards(row.devices, dim))
    owner.register_state_dict_post_hook(
        functools.partial(_full_key_hook, name=name))
    owner.register_load_state_dict_pre_hook(
        functools.partial(_split_key_hook, name=name))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def tensor_parallel_(module: nn.Module, devices: Sequence,
                     min_size: int = MIN_SIZE) -> nn.Module:
    """Split ``module`` in place over the row ``devices`` (lead first) by
    the reference's rule and return it. Call it once the weights are
    loaded or drawn: the module is moved to the lead, then every layer
    whose weight the rule splits becomes a :class:`ColumnParallel` or a
    :class:`GatheredLSTM`, and every other split parameter a
    :class:`GatherShards` parametrization. A row of one device only moves
    the module. Do not move a split module with ``.to(device)``: that
    would put every shard on one device."""
    devices = [resolve_device(d) for d in devices]
    module.to(devices[0])
    n = len(devices)
    if n < 2:
        return module
    row = _Row(devices)
    for qual, m in list(module.named_modules()):
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.Embedding)):
            if split_dim(m, "weight", m.weight, n, min_size) is not None:
                _replace(module, qual, ColumnParallel(m, row))
        elif isinstance(m, nn.LSTM):
            dims = {w: split_dim(m, w, getattr(m, w), n, min_size)
                    for w in m._flat_weights_names}
            if any(d is not None for d in dims.values()):
                _replace(module, qual, GatheredLSTM(m, row, dims))
        else:
            for name, p in list(m._parameters.items()):
                dim = None if p is None else split_dim(m, name, p, n,
                                                       min_size)
                if dim is not None:
                    _split_parameter(m, name, row, dim)
    return module


def _replace(root: nn.Module, qual: str, new: nn.Module) -> None:
    parent, _, attr = qual.rpartition(".")
    setattr(root.get_submodule(parent), attr, new)


def n_split(module: nn.Module) -> int:
    """How many of ``module``'s state-dict tensors are held split."""
    n = 0
    for m in module.modules():
        if isinstance(m, _Sharded):
            n += sum(d is not None for d in m._held.values())
        elif isinstance(m, GatherShards):
            n += 1
    return n


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state dict on the CPU under the unsplit model's keys
    and at its full shapes, whether or not the module is split: what a
    checkpoint holds and any unsplit model of the same architecture
    loads."""
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}
