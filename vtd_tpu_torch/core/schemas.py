"""Result summary (the port's copy of ``vtd_tpu/core/schemas.py:summarize``).

Wire formats, as the reference pipeline's: detection dicts
``{'bbox', 'confidence', 'polygon'}``, recognized-region dicts
``{'bbox', 'text', 'detection_confidence', 'recognition_confidence',
'polygon'}``, per-frame dicts ``{'frame_number', 'timestamp',
'detections'}`` and the summary below.
"""
from __future__ import annotations

from typing import Any, Dict, List


def summarize(
    results: List[Dict[str, Any]], processing_time: float, frame_count: int
) -> Dict[str, Any]:
    """Aggregate per-frame result dicts into the summary dict: counts,
    whitespace-stripped unique texts, mean confidences over every
    detection, wall-clock fps."""
    total_detections = sum(len(f["detections"]) for f in results)
    frames_with_text = sum(1 for f in results if f["detections"])

    det_confs: List[float] = []
    rec_confs: List[float] = []
    detected_texts: set = set()
    for f in results:
        for d in f["detections"]:
            det_confs.append(float(d["detection_confidence"]))
            rec_confs.append(float(d["recognition_confidence"]))
            t = d["text"].strip()
            if t:
                detected_texts.add(t)

    n = max(total_detections, 1)
    return {
        "total_frames": frame_count,
        "frames_with_text": frames_with_text,
        "total_detections": total_detections,
        "unique_texts": len(detected_texts),
        "detected_texts": sorted(detected_texts),
        "avg_detection_confidence": float(sum(det_confs) / n) if det_confs else 0.0,
        "avg_recognition_confidence": float(sum(rec_confs) / n) if rec_confs else 0.0,
        "processing_time_seconds": processing_time,
        "fps_processed": frame_count / processing_time if processing_time > 0 else 0.0,
    }
