"""Processing service: job status, cancellation, exports, annotation.

Port of ``vtd_tpu/serve/services/processing_service.py``.
Byte-compatible outputs with reference
``app/services/processing_service.py``: CSV header row (:66-70), the
ICDAR-like XML layout (:92-137), and the annotated-video overlay (green
boxes, "text (conf)" labels, mp4v, :139-218).
"""
from __future__ import annotations

import csv
import io
import logging
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ...core.config import settings
from ..queue import AsyncResult, task_queue

logger = logging.getLogger(__name__)

_CSV_COLUMNS = (
    "frame_number", "timestamp", "text", "bbox_x1", "bbox_y1",
    "bbox_x2", "bbox_y2", "detection_confidence", "recognition_confidence",
)


def _bbox4(det: Dict[str, Any]) -> List[Any]:
    return det.get("bbox", [0, 0, 0, 0])


def _csv_rows(frame_results: List[Dict[str, Any]]):
    """Flatten per-frame result dicts into CSV row tuples."""
    for fr in frame_results:
        head = (fr.get("frame_number", 0), fr.get("timestamp", 0.0))
        for det in fr.get("detections", []):
            yield (
                *head,
                det.get("text", ""),
                *_bbox4(det),
                det.get("detection_confidence", 0.0),
                det.get("recognition_confidence", 0.0),
            )


def _xml_summary(root: ET.Element, summary: Dict[str, Any]) -> None:
    node = ET.SubElement(root, "summary")
    for key, value in summary.items():
        ET.SubElement(node, key).text = str(value)


def _xml_frame(parent: ET.Element, fr: Dict[str, Any]) -> None:
    node = ET.SubElement(
        parent,
        "frame",
        number=str(fr.get("frame_number", 0)),
        timestamp=str(fr.get("timestamp", 0.0)),
    )
    for det in fr.get("detections", []):
        obj = ET.SubElement(
            node,
            "object",
            transcription=det.get("text", ""),
            detection_confidence=str(det.get("detection_confidence", 0.0)),
            recognition_confidence=str(det.get("recognition_confidence", 0.0)),
        )
        x1, y1, x2, y2 = _bbox4(det)
        # 4 corner Points, clockwise from top-left (ICDAR convention)
        for px, py in ((x1, y1), (x2, y1), (x2, y2), (x1, y2)):
            ET.SubElement(obj, "Point", x=str(px), y=str(py))


class ProcessingService:
    def __init__(self, queue=None):
        self.queue = queue or task_queue

    # -- task control (parity :30-57) ------------------------------------
    def get_task_status(self, task_id: str) -> Dict[str, Any]:
        try:
            result = AsyncResult(task_id, self.queue)
            out: Dict[str, Any] = {"status": result.state}
            if result.state == "PROGRESS":
                out["info"] = result.info or {}
            elif result.state == "FAILURE":
                out["info"] = {"error": str(result.result)}
                out["traceback"] = result.traceback
            else:
                out["info"] = result.info or {}
            return out
        except Exception as e:
            logger.error("Failed to get task status: %s", e)
            return {"status": "UNKNOWN", "info": {"error": str(e)}}

    def cancel_task(self, task_id: str) -> bool:
        try:
            return self.queue.revoke(task_id, terminate=True)
        except Exception as e:
            logger.error("Failed to cancel task: %s", e)
            return False

    # -- exports ------------------------------------------------------------
    # Both formats are byte-compatibility contracts with the reference
    # (CSV column order: processing_service.py:66-70; ICDAR-like XML
    # element/attribute names: :92-137) — consumers parse them.

    async def export_results_csv(self, results_data: Dict[str, Any]) -> str:
        try:
            buf = io.StringIO()
            writer = csv.writer(buf)
            writer.writerow(_CSV_COLUMNS)
            writer.writerows(_csv_rows(results_data.get("results", [])))
            return buf.getvalue()
        except Exception as e:
            logger.error("CSV export failed: %s", e)
            return ""

    async def export_results_xml(self, results_data: Dict[str, Any]) -> str:
        try:
            root = ET.Element("video_text_detection")
            _xml_summary(root, results_data.get("summary", {}))
            frames = ET.SubElement(root, "frames")
            for fr in results_data.get("results", []):
                _xml_frame(frames, fr)
            return ET.tostring(root, encoding="unicode")
        except Exception as e:
            logger.error("XML export failed: %s", e)
            return ""

    # -- annotated video ----------------------------------------------------
    async def create_annotated_video(
        self, video_path: str, results_data: Dict[str, Any]
    ) -> Optional[str]:
        import cv2

        try:
            output_dir = Path(settings.output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            output_path = output_dir / f"{Path(video_path).stem}_annotated.mp4"

            cap = cv2.VideoCapture(video_path)
            if not cap.isOpened():
                return None
            fps = cap.get(cv2.CAP_PROP_FPS)
            width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            out = cv2.VideoWriter(
                str(output_path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                (width, height),
            )

            dets_by_frame = {
                fr.get("frame_number", 0): fr.get("detections", [])
                for fr in results_data.get("results", [])
            }
            frame_number = 0
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                if frame_number in dets_by_frame:
                    frame = self._draw_detections(
                        frame, dets_by_frame[frame_number]
                    )
                out.write(frame)
                frame_number += 1
            cap.release()
            out.release()
            return str(output_path)
        except Exception as e:
            logger.error("Annotated video creation failed: %s", e)
            return None

    def _draw_detections(
        self, frame: np.ndarray, detections: List[Dict[str, Any]]
    ) -> np.ndarray:
        import cv2

        for det in detections:
            bbox = det.get("bbox", [])
            if len(bbox) != 4:
                continue
            x1, y1, x2, y2 = (int(v) for v in bbox)
            text = det.get("text", "")
            conf = det.get("detection_confidence", 0.0)
            cv2.rectangle(frame, (x1, y1), (x2, y2), (0, 255, 0), 2)
            label = f"{text} ({conf:.2f})"
            (lw, lh), _ = cv2.getTextSize(
                label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1
            )
            cv2.rectangle(
                frame, (x1, y1 - lh - 10), (x1 + lw, y1), (0, 255, 0), -1
            )
            cv2.putText(
                frame, label, (x1, y1 - 5), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (0, 0, 0), 1,
            )
        return frame
