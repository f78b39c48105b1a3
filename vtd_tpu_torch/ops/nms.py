"""Box utilities: IoU, NMS, and cross-frame text-region merging (port of
``vtd_tpu/ops/nms.py``). ``iou_matrix`` and ``nms`` are tensor functions
of static shape [K] with valid masks; ``temporal_dedup`` runs on the host
over the pipeline's result dicts.
"""
from __future__ import annotations

import numpy as np
import torch


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """[N, 4] x [M, 4] (x1, y1, x2, y2) -> [N, M] IoU."""
    ax1, ay1, ax2, ay2 = (boxes_a[:, i:i + 1] for i in range(4))  # [N,1]
    bx1, by1, bx2, by2 = (boxes_b[None, :, i] for i in range(4))  # [1,M]
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    union = area_a + area_b - inter
    return inter / union.clamp(min=1e-9)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.5,
) -> torch.Tensor:
    """Greedy NMS over [K] boxes; returns a keep mask [K]. Iterates K
    times with masking and never waits for the device."""
    k = boxes.shape[0]
    neg_inf = float("-inf")
    order_scores = torch.where(valid, scores, neg_inf)
    iou = iou_matrix(boxes, boxes)
    index = torch.arange(k, device=boxes.device)
    keep = torch.zeros(k, dtype=torch.bool, device=boxes.device)
    alive = valid.clone()
    for _ in range(k):
        s = torch.where(alive, order_scores, neg_inf)
        best = torch.argmax(s)
        best_alive = s[best] > neg_inf
        # OR-update: with nothing alive argmax returns 0 and must not
        # clobber an earlier decision for slot 0
        keep = keep | ((index == best) & best_alive)
        overlap = iou[best] >= iou_threshold
        alive = alive & ~(overlap & best_alive) & (index != best)
    return keep


def temporal_dedup(frame_results, iou_threshold: float = 0.7):
    """Host-side: merge detections of the same text in overlapping
    positions across consecutive frames into tracks.

    frame_results: list of per-frame dicts ({'frame_number',
    'detections': [...]}), the pipeline's wire format. Returns a list of
    track dicts: {'text', 'first_frame', 'last_frame', 'count', 'bbox',
    'max_detection_confidence', 'max_recognition_confidence'}.
    """
    tracks = []  # each: dict + np bbox of last sighting
    for fr in frame_results:
        fn = fr["frame_number"]
        for det in fr["detections"]:
            bbox = np.asarray(det["bbox"], np.float32)
            text = det["text"].strip()
            if not text:
                continue
            matched = None
            for tr in tracks:
                if tr["text"] != text or fn - tr["last_frame"] > 3:
                    continue
                a, b = tr["_bbox"], bbox
                ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
                ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
                inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
                union = (
                    (a[2] - a[0]) * (a[3] - a[1])
                    + (b[2] - b[0]) * (b[3] - b[1])
                    - inter
                )
                if union > 0 and inter / union >= iou_threshold:
                    matched = tr
                    break
            if matched is None:
                tracks.append(
                    {
                        "text": text,
                        "first_frame": fn,
                        "last_frame": fn,
                        "count": 1,
                        "_bbox": bbox,
                        "max_detection_confidence": det[
                            "detection_confidence"
                        ],
                        "max_recognition_confidence": det[
                            "recognition_confidence"
                        ],
                    }
                )
            else:
                matched["last_frame"] = fn
                matched["count"] += 1
                matched["_bbox"] = bbox
                matched["max_detection_confidence"] = max(
                    matched["max_detection_confidence"],
                    det["detection_confidence"],
                )
                matched["max_recognition_confidence"] = max(
                    matched["max_recognition_confidence"],
                    det["recognition_confidence"],
                )
    out = []
    for tr in tracks:
        tr = dict(tr)
        tr["bbox"] = [int(v) for v in tr.pop("_bbox")]
        out.append(tr)
    return out
