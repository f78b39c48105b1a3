"""Plain DB postprocess of one probability map, in numpy, scipy and cv2.

The semantics the program's device postprocess states: threshold the map,
take 8-connected components on a grid of ``stride`` x ``stride`` cells
(a cell is foreground when any of its pixels is), keep the ``max_dets``
largest components of more than one cell (larger first, then the lower
first cell), each component's area being its cells times ``stride``
squared; a component is valid from ``min_area`` up. Its box is the
minimum-area rectangle around its boundary pixels (foreground pixels
with a background 4-neighbour, the map's edge counting as background),
as ``cv2.minAreaRect`` gives it exactly; the axis-aligned box of that
rectangle's corners is clamped to the map. Where rectangles at other
angles come within ``NEAR_MIN`` of that area (a round or square
component, whose least rectangle may lie at any angle; or a search over
angles that stops short of the exact one), each is as much the answer:
``boxes_near`` gives the boxes of all of them. A box spanning at least
``max_box_frac`` of the map both ways is not valid. The score is the mean
probability over the box's pixels ``[floor(x1), ceil(x2))`` x
``[floor(y1), ceil(y2))``, at least one pixel each way.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

NEAR_MIN = 0.01  # share of the least area within which a rectangle counts
ANGLES = np.deg2rad(np.arange(0.0, 90.0, 0.05))


def components(binary: np.ndarray):
    """8-connected labels of a 2-D bool grid -> (labels, count)."""
    from scipy import ndimage

    return ndimage.label(binary, structure=np.ones((3, 3), bool))


def postprocess(prob: np.ndarray, thresh: float = 0.5, max_dets: int = 64,
                min_area: float = 100.0, max_box_frac: float = 0.95,
                stride: int = 2) -> Dict[str, np.ndarray]:
    """prob [H, W] float -> boxes [K, 4], areas [K], valid [K] (K = max_dets)."""
    import cv2

    h, w = prob.shape
    hs, ws = h // stride, w // stride
    full = prob > thresh
    cropped = full[:hs * stride, :ws * stride]
    cells = cropped.reshape(hs, stride, ws, stride).any(axis=(1, 3))
    labels, n = components(cells)
    flat = labels.ravel()
    counts = np.bincount(flat, minlength=n + 1)
    first = np.full(n + 1, flat.size, np.int64)
    np.minimum.at(first, flat, np.arange(flat.size))
    comps = [c for c in range(1, n + 1) if counts[c] > 1]
    comps.sort(key=lambda c: (-counts[c], first[c]))
    comps = comps[:max_dets]

    padded = np.pad(cropped, 1)
    interior = (padded[:-2, 1:-1] & padded[2:, 1:-1]
                & padded[1:-1, :-2] & padded[1:-1, 2:])
    boundary = cropped & ~interior
    cell_label = np.repeat(np.repeat(labels, stride, 0), stride, 1)

    boxes = np.zeros((max_dets, 4), np.float64)
    areas = np.zeros(max_dets, np.float64)
    valid = np.zeros(max_dets, bool)
    near = [np.zeros((0, 4))] * max_dets
    for slot, c in enumerate(comps):
        ys, xs = np.nonzero(boundary & (cell_label == c))
        areas[slot] = counts[c] * stride * stride
        pts = np.stack([xs, ys], 1).astype(np.float32)
        rect = cv2.minAreaRect(pts)
        corners = cv2.boxPoints(rect)
        boxes[slot] = _clamped_box(corners[None], w, h)[0]
        near[slot] = np.concatenate([boxes[slot][None], boxes_near(
            pts, rect[1][0] * rect[1][1], w, h)])
        filling = ((boxes[slot, 2] - boxes[slot, 0] >= max_box_frac * w)
                   and (boxes[slot, 3] - boxes[slot, 1] >= max_box_frac * h))
        valid[slot] = areas[slot] >= min_area and not (
            max_box_frac < 1.0 and filling)
    return {"boxes": boxes, "areas": areas, "valid": valid, "near": near}


def _clamped_box(corners: np.ndarray, w: int, h: int) -> np.ndarray:
    """corners [m, 4, 2] -> the axis-aligned boxes [m, 4], clamped to the map."""
    lo, hi = corners.min(1), corners.max(1)
    return np.stack([np.clip(lo[:, 0], 0, w), np.clip(lo[:, 1], 0, h),
                     np.clip(hi[:, 0], 0, w), np.clip(hi[:, 1], 0, h)], 1)


def boxes_near(pts: np.ndarray, least: float, w: int, h: int) -> np.ndarray:
    """The clamped boxes of the rectangles around ``pts``, one every 0.05
    degrees, whose area is within ``NEAR_MIN`` of the least (``least``,
    or the sweep's own least where that is lower) -> [m, 4]."""
    import cv2

    hull = cv2.convexHull(pts)[:, 0, :].astype(np.float64)
    c, s = np.cos(ANGLES), np.sin(ANGLES)
    u = hull[:, :1] * c + hull[:, 1:] * s  # [n, angles]
    v = -hull[:, :1] * s + hull[:, 1:] * c
    u0, u1, v0, v1 = u.min(0), u.max(0), v.min(0), v.max(0)
    area = (u1 - u0) * (v1 - v0)
    keep = area <= min(float(least), float(area.min())) * (1.0 + NEAR_MIN)
    c, s, u0, u1, v0, v1 = c[keep], s[keep], u0[keep], u1[keep], v0[keep], v1[keep]
    us = np.stack([u0, u1, u1, u0], 1)
    vs = np.stack([v0, v0, v1, v1], 1)
    corners = np.stack([us * c[:, None] - vs * s[:, None],
                        us * s[:, None] + vs * c[:, None]], -1)
    return _clamped_box(corners, w, h)


def box_score(prob: np.ndarray, box) -> float:
    """Mean probability over a box's pixels, as the module's docstring says."""
    h, w = prob.shape
    x1 = int(np.clip(np.floor(box[0]), 0, w - 1))
    y1 = int(np.clip(np.floor(box[1]), 0, h - 1))
    x2 = int(min(max(np.ceil(box[2]), x1 + 1), w))
    y2 = int(min(max(np.ceil(box[3]), y1 + 1), h))
    return float(prob[y1:y2, x1:x2].astype(np.float64).mean())


def iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else float(np.allclose(a, b))
