"""DBNet training labels on the device (port of
``vtd_tpu/train/labels.py``).

A binary probability map filled inside each box, and a threshold map
filled inside each box shrunk toward its centre by ``shrink_ratio``.
Boxes come as a fixed-size [..., K, 4] tensor with a validity mask, so a
whole batch of maps is one broadcast over [..., K, H, W], with no loop
over boxes.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _fill(x1, y1, x2, y2, valid, height: int, width: int) -> torch.Tensor:
    """[..., K] box edges -> [..., H, W] float32 union of the boxes
    (x1 <= x < x2 and y1 <= y < y2: the slice ``map[y1:y2, x1:x2]``)."""
    dev = x1.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    in_x = (xs >= x1[..., None]) & (xs < x2[..., None])  # [..., K, W]
    in_y = (ys >= y1[..., None]) & (ys < y2[..., None])  # [..., K, H]
    inside = in_y[..., :, None] & in_x[..., None, :] & valid[..., None, None]
    return inside.any(dim=-3).to(torch.float32)


def make_maps(
    boxes: torch.Tensor, valid: torch.Tensor, height: int, width: int,
    shrink_ratio: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes [..., K, 4] (x1, y1, x2, y2), valid [..., K] -> (prob_map,
    thresh_map), each [..., H, W] float32, on the boxes' device.

    The shrunk edges ``c + (e - c) * (1 - shrink_ratio)`` are rounded
    once to float32 from a float64 product, as the reference's XLA:CPU
    program rounds its fused multiply-add; a box edge on a pixel
    boundary then lands on the same side of it.
    """
    boxes = boxes.to(torch.float32)
    valid = valid.to(torch.bool)
    x1, y1, x2, y2 = boxes.unbind(-1)
    prob = _fill(x1, y1, x2, y2, valid, height, width)
    k = float(torch.tensor(1.0 - shrink_ratio, dtype=torch.float32))
    b64 = boxes.to(torch.float64)
    c = torch.stack([(b64[..., 0] + b64[..., 2]) / 2.0,
                     (b64[..., 1] + b64[..., 3]) / 2.0], -1)
    c = c.to(torch.float32).to(torch.float64)  # the centre is float32
    lo = (c + (b64[..., 0:2] - c) * k).to(torch.float32)
    hi = (c + (b64[..., 2:4] - c) * k).to(torch.float32)
    thresh = _fill(lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1], valid,
                   height, width)
    return prob, thresh


def make_maps_batch(
    boxes: torch.Tensor, valid: torch.Tensor, height: int, width: int,
    shrink_ratio: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes [B, K, 4], valid [B, K] -> (prob_maps, thresh_maps) [B, H, W]
    (the reference's vmap of ``make_maps``)."""
    return make_maps(boxes, valid, height, width, shrink_ratio)
