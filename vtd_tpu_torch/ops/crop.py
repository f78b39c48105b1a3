"""Crop every detection box to a fixed-size strip for the recognizer.

Port of ``vtd_tpu/ops/crop.py:crop_and_resize_boxes_mm``: bilinear
crop+resize is separable, so per-box triangle-kernel interpolation
matrices A_y [K, out_h, H] and A_x [K, out_w, W] contract against the
frame in two float32 products. Batched over frames here.
"""
from __future__ import annotations

import torch


def crop_and_resize_boxes_mm(
    images: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    out_h: int = 32,
    out_w: int = 128,
) -> torch.Tensor:
    """images [B, H, W, 3] (uint8 or float), boxes [B, K, 4] (x1, y1, x2,
    y2) in image coordinates, valid [B, K] bool -> crops
    [B, K, out_h, out_w, 3] float32 in [0, 1]; invalid slots are zero.
    Same grid as ``cv2.resize`` of each box: src = (dst + 0.5) * scale - 0.5.
    """
    b, h, w = images.shape[:3]
    dev = images.device
    f32 = torch.float32
    x1, y1, x2, y2 = boxes.unbind(-1)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)

    gy = (torch.arange(out_h, dtype=f32, device=dev) + 0.5) / out_h
    gx = (torch.arange(out_w, dtype=f32, device=dev) + 0.5) / out_w

    def fma(a, b, c):  # one rounding, as the reference's compiled code
        return (a.double() * b.double() + c.double()).to(f32)

    yq = torch.clamp(fma(gy, bh[..., None], y1[..., None]) - 0.5, 0, h - 1)
    xq = torch.clamp(fma(gx, bw[..., None], x1[..., None]) - 0.5, 0, w - 1)

    rows = torch.arange(h, dtype=f32, device=dev)
    cols = torch.arange(w, dtype=f32, device=dev)
    a_y = torch.clamp(1.0 - torch.abs(rows - yq[..., None]), min=0.0)
    a_x = torch.clamp(1.0 - torch.abs(cols - xq[..., None]), min=0.0)

    img = images.to(f32)
    tmp = torch.einsum("bkyh,bhwc->bkywc", a_y, img)
    crops = torch.einsum("bkxw,bkywc->bkyxc", a_x, tmp) / 255.0
    return torch.where(valid[..., None, None, None], crops, 0.0)
