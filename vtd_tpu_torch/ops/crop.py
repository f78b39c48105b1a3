"""Crop every detection box to a fixed-size strip for the recognizer
(port of ``vtd_tpu/ops/crop.py``).

``crop_and_resize_boxes_mm`` (the video paths' crop): bilinear
crop+resize is separable, so per-box triangle-kernel interpolation
matrices A_y [K, out_h, H] and A_x [K, out_w, W] contract against the
frame in two float32 products. ``crop_and_resize_boxes`` computes the
same crop as a gather of four neighbours per output pixel, and
``rectify_polygons`` samples rotated rectangles onto straight strips.
All three take one image [H, W, 3] with [K, ...] boxes, as the
reference's do, or a batch [B, H, W, 3] with [B, K, ...].
"""
from __future__ import annotations

import torch

from ._rank import one_or_batch


@one_or_batch("H, W, 3", "image", "boxes", "valid")
def crop_and_resize_boxes_mm(
    image: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    out_h: int = 32,
    out_w: int = 128,
) -> torch.Tensor:
    """image [B, H, W, 3] (uint8 or float), boxes [B, K, 4] (x1, y1, x2,
    y2) in image coordinates, valid [B, K] bool -> crops
    [B, K, out_h, out_w, 3] float32 in [0, 1]; invalid slots are zero.
    One image [H, W, 3] with boxes [K, 4] and valid [K] gives
    [K, out_h, out_w, 3], as the reference's function.
    Same grid as ``cv2.resize`` of each box: src = (dst + 0.5) * scale - 0.5.
    """
    b, h, w = image.shape[:3]
    dev = image.device
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

    img = image.to(f32)
    tmp = torch.einsum("bkyh,bhwc->bkywc", a_y, img)
    crops = torch.einsum("bkxw,bkywc->bkyxc", a_x, tmp) / 255.0
    return torch.where(valid[..., None, None, None], crops, 0.0)


def _bilinear_sample(
    images: torch.Tensor, xq: torch.Tensor, yq: torch.Tensor
) -> torch.Tensor:
    """Sample images [B, H, W, C] at float coordinates [B, ...] ->
    [B, ..., C], clamp-to-edge (query coordinates clamped first, as the
    reference does)."""
    b, h, w = images.shape[:3]
    xq = torch.clamp(xq, 0.0, w - 1.0)
    yq = torch.clamp(yq, 0.0, h - 1.0)
    x0 = torch.floor(xq)
    y0 = torch.floor(yq)
    fx = (xq - x0)[..., None]
    fy = (yq - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    img = images.to(torch.float32)
    bi = torch.arange(b, device=images.device).reshape(
        (b,) + (1,) * (xq.dim() - 1))
    top = img[bi, y0, x0] * (1 - fx) + img[bi, y0, x1] * fx
    bot = img[bi, y1, x0] * (1 - fx) + img[bi, y1, x1] * fx
    return top * (1 - fy) + bot * fy


@one_or_batch("H, W, 3", "image", "boxes", "valid")
def crop_and_resize_boxes(
    image: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    out_h: int = 32,
    out_w: int = 128,
) -> torch.Tensor:
    """Axis-aligned crop+resize of K boxes by a bilinear gather, what
    ``cv2.resize(frame[y1:y2, x1:x2], (out_w, out_h))`` gives per box.

    image [H, W, 3] (uint8 or float), boxes [K, 4] (x1, y1, x2, y2),
    valid [K] bool -> [K, out_h, out_w, 3] float32 in [0, 1] (or the
    same with a leading batch axis); invalid slots are zero.
    """
    f32 = torch.float32
    dev = image.device
    x1, y1, x2, y2 = boxes.to(f32).unbind(-1)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    gx = (torch.arange(out_w, dtype=f32, device=dev) + 0.5) / out_w
    gy = (torch.arange(out_h, dtype=f32, device=dev) + 0.5) / out_h

    def fma(a, b, c):  # one rounding, as the reference's compiled code
        return (a.double() * b.double() + c.double()).to(f32)

    xs = fma(gx, bw[..., None], x1[..., None]) - 0.5  # [B, K, out_w]
    ys = fma(gy, bh[..., None], y1[..., None]) - 0.5  # [B, K, out_h]
    shape = xs.shape[:2] + (out_h, out_w)
    xq = xs[..., None, :].expand(shape)
    yq = ys[..., :, None].expand(shape)
    crops = _bilinear_sample(image, xq, yq) / 255.0
    crops = torch.where(valid[..., None, None, None], crops, 0.0)
    return crops


@one_or_batch("H, W, 3", "image", "polygons", "valid")
def rectify_polygons(
    image: torch.Tensor,
    polygons: torch.Tensor,
    valid: torch.Tensor,
    out_h: int = 32,
    out_w: int = 128,
) -> torch.Tensor:
    """Sample each rotated rectangle onto a straight out_h x out_w strip.

    polygons [K, 4, 2]: corners ordered (u-min/v-min, u-max/v-min,
    u-max/v-max, u-min/v-max) as ``db_postprocess`` gives them; the
    longer edge maps to the output width. -> [K, out_h, out_w, 3]
    float32 in [0, 1] (or batched, as :func:`crop_and_resize_boxes`).
    """
    f32 = torch.float32
    dev = image.device
    polygons = polygons.to(f32)
    p0, p1, p3 = polygons[..., 0, :], polygons[..., 1, :], polygons[..., 3, :]
    eu = p1 - p0
    ev = p3 - p0
    swap = (torch.linalg.norm(ev, dim=-1) > torch.linalg.norm(eu, dim=-1))
    e_w = torch.where(swap[..., None], ev, eu)
    e_h = torch.where(swap[..., None], eu, ev)
    gx = (torch.arange(out_w, dtype=f32, device=dev) + 0.5) / out_w
    gy = (torch.arange(out_h, dtype=f32, device=dev) + 0.5) / out_h

    def query(axis):
        return (
            p0[..., axis, None, None]
            + gy[:, None] * e_h[..., axis, None, None]
            + gx[None, :] * e_w[..., axis, None, None]
        )

    crops = _bilinear_sample(image, query(0), query(1)) / 255.0
    crops = torch.where(valid[..., None, None, None], crops, 0.0)
    return crops
