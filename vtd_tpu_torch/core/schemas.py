"""Typed result schemas and the summary (the port's copy of
``vtd_tpu/core/schemas.py``).

The dataclasses are the typed form; ``.to_dict()`` gives the wire
formats of the reference pipeline's outputs: detection dicts ``{'bbox',
'confidence', 'polygon'}``, recognized-region dicts ``{'bbox', 'text',
'detection_confidence', 'recognition_confidence', 'polygon'}``,
per-frame dicts ``{'frame_number', 'timestamp', 'detections'}``, the
summary of :func:`summarize` and the video result.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class Detection:
    """A detected text region in original-frame pixel coordinates."""

    bbox: List[int]  # [x1, y1, x2, y2]
    confidence: float
    polygon: List[List[int]] = field(default_factory=list)  # 4 corners

    def to_dict(self) -> Dict[str, Any]:
        return {
            "bbox": [int(v) for v in self.bbox],
            "confidence": float(self.confidence),
            "polygon": [[int(x), int(y)] for x, y in self.polygon],
        }


@dataclass
class RecognizedRegion:
    """A detection plus its transcript."""

    bbox: List[int]
    text: str
    detection_confidence: float
    recognition_confidence: float
    polygon: List[List[int]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "bbox": [int(v) for v in self.bbox],
            "text": self.text,
            "detection_confidence": float(self.detection_confidence),
            "recognition_confidence": float(self.recognition_confidence),
            "polygon": [[int(x), int(y)] for x, y in self.polygon],
        }


@dataclass
class FrameResult:
    frame_number: int
    timestamp: float
    detections: List[RecognizedRegion] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "frame_number": int(self.frame_number),
            "timestamp": float(self.timestamp),
            "detections": [d.to_dict() for d in self.detections],
        }


@dataclass
class PipelineSummary:
    total_frames: int
    frames_with_text: int
    total_detections: int
    unique_texts: int
    detected_texts: List[str]
    avg_detection_confidence: float
    avg_recognition_confidence: float
    processing_time_seconds: float
    fps_processed: float

    def to_dict(self) -> Dict[str, Any]:
        return {
            "total_frames": int(self.total_frames),
            "frames_with_text": int(self.frames_with_text),
            "total_detections": int(self.total_detections),
            "unique_texts": int(self.unique_texts),
            "detected_texts": list(self.detected_texts),
            "avg_detection_confidence": float(self.avg_detection_confidence),
            "avg_recognition_confidence": float(
                self.avg_recognition_confidence),
            "processing_time_seconds": float(self.processing_time_seconds),
            "fps_processed": float(self.fps_processed),
        }


@dataclass
class VideoResult:
    """Top-level result of processing one video."""

    status: str  # 'success' | 'failed'
    results: List[FrameResult] = field(default_factory=list)
    summary: Dict[str, Any] = field(default_factory=dict)
    video_info: Dict[str, Any] = field(default_factory=dict)
    error: str = ""

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "status": self.status,
            "results": [r.to_dict() for r in self.results],
        }
        if self.status == "success":
            out["summary"] = self.summary
            out["video_info"] = self.video_info
        else:
            out["error"] = self.error
        return out


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
