"""DBNet: ResNet50-FPN + differentiable-binarization head (port of
``vtd_tpu/models/dbnet.py``). NCHW; maps come out at input resolution.

The compute dtype is the module's parameter dtype: bf16 on the card, as
the reference computes, float32 for the CPU parity tests and for
training (the reference trains ``DBNet(dtype=float32)``). The sigmoid
runs in float32; the map is returned in the compute dtype in eval mode
and in float32 in train mode, as the reference returns it.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import BN_EPS, BatchNorm2d, ResNet50


def _upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class FPNNeck(nn.Module):
    """C2..C5 -> 1x1 laterals (256), top-down nearest adds, 3x3 smooth to
    64 per level, upsample to stride 4 and concatenate (256)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256):
        super().__init__()
        lat, sm = out_channels, out_channels // 4
        for lvl, ch in zip((2, 3, 4, 5), in_channels):
            setattr(self, f"lateral{lvl}", nn.Conv2d(ch, lat, 1, bias=False))
            setattr(
                self, f"smooth{lvl}",
                nn.Conv2d(lat, sm, 3, padding=1, bias=False),
            )

    def forward(self, feats) -> torch.Tensor:
        c2, c3, c4, c5 = feats
        p5 = self.lateral5(c5)
        p4 = self.lateral4(c4) + _upsample_nearest(p5, 2)
        p3 = self.lateral3(c3) + _upsample_nearest(p4, 2)
        p2 = self.lateral2(c2) + _upsample_nearest(p3, 2)
        o5 = _upsample_nearest(self.smooth5(p5), 8)
        o4 = _upsample_nearest(self.smooth4(p4), 4)
        o3 = _upsample_nearest(self.smooth3(p3), 2)
        o2 = self.smooth2(p2)
        return torch.cat([o2, o3, o4, o5], dim=1)


class _Upsample2x(nn.Module):
    """2x learned upsampling: 1x1 conv (with bias) to 4C, then
    depth-to-space. Output channels are in ``F.pixel_shuffle`` order,
    c*4 + (a*2+b); the reference orders them (a*2+b)*C + c, and
    ``convert.py`` permutes. A ``ConvTranspose2d`` would not do: its [C]
    bias cannot hold the reference's bias per phase."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, 4 * features, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.conv(x), 2)


class _HeadBranch(nn.Module):
    """Conv3x3-BN-ReLU -> up2x-BN-ReLU -> up2x -> sigmoid."""

    def __init__(self, in_channels: int = 256):
        super().__init__()
        mid = in_channels // 4
        self.conv = nn.Conv2d(in_channels, mid, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(mid, eps=BN_EPS)
        self.up1 = _Upsample2x(mid, mid)
        self.bn2 = BatchNorm2d(mid, eps=BN_EPS)
        self.up2 = _Upsample2x(mid, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv(x)))
        x = F.relu(self.bn2(self.up1(x)))
        x = self.up2(x)
        y = torch.sigmoid(x.float())
        return y if self.training else y.to(x.dtype)


class DBHead(nn.Module):
    def __init__(self, in_channels: int = 256):
        super().__init__()
        self.probability = _HeadBranch(in_channels)
        self.threshold = _HeadBranch(in_channels)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"probability": self.probability(x),
                "threshold": self.threshold(x)}


class DBNet(nn.Module):
    """Normalised NCHW image -> {'probability', 'threshold'} [B,1,H,W]."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 db_k: float = 50.0):
        super().__init__()
        self.db_k = db_k
        self.backbone = ResNet50()
        self.fpn = FPNNeck()
        self.head = DBHead()
        self.to(dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        dt = next(self.parameters()).dtype
        return self.fpn(self.backbone(x.to(dt)))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.head(self.features(x))

    def probability(self, x: torch.Tensor) -> torch.Tensor:
        """Inference path: only the probability branch -> [B, H, W]."""
        return self.head.probability(self.features(x))[:, 0]

    def binary(self, out: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The differentiable binarization ``sigmoid(db_k * (P - T))`` of
        a forward's maps (the DB formulation; the loss does not use it)."""
        return torch.sigmoid(self.db_k * (out["probability"]
                                          - out["threshold"]))
