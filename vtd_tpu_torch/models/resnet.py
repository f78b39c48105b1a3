"""ResNet-50 backbone returning the C2..C5 taps (port of
``vtd_tpu/models/resnet.py``).

Module names follow torchvision's ``resnet50`` (``conv1``, ``bn1``,
``layerN.i.{conv1..3,bn1..3,downsample}``), the layout the reference's
torch importer maps from, so such state dicts load directly. NCHW.
The reference's stem is a space-to-depth rewrite of the plain 7x7/2
convolution with padding 3 on the same ``conv1`` kernel; here it is that
plain convolution. Every padding is explicit, as in the reference.

``BatchNorm2d`` here is the one BatchNorm of the port's three models: in
eval mode torch's, in train mode flax's (``nn.BatchNorm(momentum=0.9)``),
so that the trainers update the running statistics as the reference's do.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_sum, current_data_group

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode semantics.

    Train mode normalises with the batch's biased statistics in float32
    (float64 for a float64 input) and updates the running statistics as
    flax does: ``0.9 * old + 0.1 * batch``, the batch variance biased and
    taken as ``E[x^2] - E[x]^2`` clipped at 0 (flax's fast variance).
    ``nn.BatchNorm2d`` would put the unbiased variance into
    ``running_var``, n/(n-1) larger, which is far off at a small
    ``B*H*W`` (the CRNN's last layers, ResNet's C5). The normalisation
    itself is torch's fused one, whose variance differs from flax's only
    in rounding. Eval mode is torch's own; the state-dict keys are
    torch's.

    Inside ``parallel.collectives.data_group`` (data-parallel training)
    the statistics are the whole batch's across the ranks, as in the
    reference's single GSPMD program: one all-reduce of the sums of
    ``x - K`` and ``(x - K)^2`` and the count, in float32, gives the global
    mean and fast variance; the batch is normalised with them and the
    running statistics are updated from them. Per-rank statistics would be
    another model. ``K`` is the running mean (the same on every rank): the
    shift keeps ``E[x^2] - E[x]^2`` from cancelling in channels whose mean
    is large against their spread, as the trained detector's stem has
    (``tools/torch_bn_precision.py`` measures it).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = current_data_group()
        if group is not None:
            return self._global_forward(x, group)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        with torch.no_grad():
            dims = (0, 2, 3)
            mean = xf.mean(dims)
            var = (xf.square().mean(dims) - mean.square()).clamp_min(0.0)
            self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
            self.num_batches_tracked.add_(1)
        y = F.batch_norm(xf, None, None, self.weight, self.bias,
                         training=True, momentum=0.0, eps=self.eps)
        return y.to(x.dtype)

    def _global_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = xf.shape[1]
        dims = (0, 2, 3)
        shape = (1, c, 1, 1)
        shift = self.running_mean.to(xf.dtype, copy=True)
        xs = xf - shift.view(shape)
        count = xf.new_full((1,), xf.numel() // c)
        sums = all_reduce_sum(
            torch.cat([xs.sum(dims), xs.square().sum(dims), count]), group)
        n = sums[-1]
        centred = sums[:c] / n
        mean = shift + centred
        var = (sums[c:2 * c] / n - centred.square()).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(
                (1 - BN_MOMENTUM) * mean.detach())
            self.running_var.mul_(BN_MOMENTUM).add_(
                (1 - BN_MOMENTUM) * var.detach())
            self.num_batches_tracked.add_(1)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here) -> 1x1, identity or projection shortcut."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        out_ch = 4 * features
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = BatchNorm2d(features, eps=BN_EPS)
        self.conv2 = nn.Conv2d(
            features, features, 3, stride=stride, padding=1, bias=False
        )
        self.bn2 = BatchNorm2d(features, eps=BN_EPS)
        self.conv3 = nn.Conv2d(features, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch, eps=BN_EPS)
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm2d(out_ch, eps=BN_EPS),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """NCHW image -> (C2, C3, C4, C5) at strides 4/8/16/32."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=BN_EPS)
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(
            zip(stage_sizes, (64, 128, 256, 512))
        ):
            blocks = []
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(in_ch, width, stride))
                in_ch = 4 * width
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        taps = []
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
            taps.append(x)
        return tuple(taps)
