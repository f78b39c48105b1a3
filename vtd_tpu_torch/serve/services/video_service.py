"""Video service: metadata, thumbnails, transcode, audio, validation.

Parity with reference ``app/services/video_service.py``: metadata probe
delegating to VideoProcessor (:19-24), 320x240 JPEG thumbnail at a
timestamp (:26-56), ffmpeg mp4/h264 transcode (:58-89), 16 kHz mono WAV
audio extraction (:91-122), video+frames+detections join (:124-147),
and validation with the same warning thresholds (>10 min, >4096 px,
>60 fps, :149-183). Port of ``vtd_tpu/serve/services/video_service.py``
over the port's ``video/processor.py``.
"""
from __future__ import annotations

import logging
import os
import subprocess
from pathlib import Path
from typing import Any, Dict, Optional


from ...core.config import settings
from ...video.processor import VideoProcessor
from ..db import (
    Database,
    FrameCRUD,
    ProcessingJobCRUD,
    TextDetectionCRUD,
    VideoCRUD,
)

logger = logging.getLogger(__name__)


class VideoService:
    def __init__(self):
        self.processor = VideoProcessor()

    async def get_video_metadata(self, video_path: str) -> Dict[str, Any]:
        return self.processor.get_video_info(video_path)

    # ------------------------------------------------------------------
    async def generate_thumbnail(
        self, video_path: str, timestamp: float = 0.0
    ) -> Optional[str]:
        import cv2

        try:
            cap = cv2.VideoCapture(video_path)
            if not cap.isOpened():
                return None
            fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(timestamp * fps))
            ret, frame = cap.read()
            cap.release()
            if not ret:
                return None
            thumb = cv2.resize(frame, (320, 240))
            out_dir = Path(settings.output_dir) / "thumbnails"
            out_dir.mkdir(parents=True, exist_ok=True)
            out_path = out_dir / f"{Path(video_path).stem}_thumb.jpg"
            cv2.imwrite(str(out_path), thumb, [cv2.IMWRITE_JPEG_QUALITY, 85])
            return str(out_path)
        except Exception as e:
            logger.error("Thumbnail generation failed: %s", e)
            return None

    # ------------------------------------------------------------------
    async def convert_video_format(
        self, input_path: str, output_format: str = "mp4"
    ) -> Optional[str]:
        """ffmpeg transcode to h264 mp4 (video_service.py:58-89)."""
        try:
            out_dir = Path(settings.output_dir) / "converted"
            out_dir.mkdir(parents=True, exist_ok=True)
            out_path = out_dir / f"{Path(input_path).stem}.{output_format}"
            cmd = [
                "ffmpeg", "-y", "-i", input_path,
                "-c:v", "libx264", "-preset", "medium", "-crf", "23",
                "-c:a", "aac", "-movflags", "+faststart", str(out_path),
            ]
            proc = subprocess.run(
                cmd, capture_output=True, timeout=600, check=False
            )
            if proc.returncode != 0:
                logger.error("ffmpeg failed: %s", proc.stderr[-500:])
                return None
            return str(out_path)
        except (OSError, subprocess.SubprocessError) as e:
            logger.error("Video conversion failed: %s", e)
            return None

    async def extract_audio(self, video_path: str) -> Optional[str]:
        """16 kHz mono WAV (video_service.py:91-122)."""
        try:
            out_dir = Path(settings.output_dir) / "audio"
            out_dir.mkdir(parents=True, exist_ok=True)
            out_path = out_dir / f"{Path(video_path).stem}.wav"
            cmd = [
                "ffmpeg", "-y", "-i", video_path,
                "-vn", "-acodec", "pcm_s16le", "-ar", "16000", "-ac", "1",
                str(out_path),
            ]
            proc = subprocess.run(
                cmd, capture_output=True, timeout=300, check=False
            )
            if proc.returncode != 0:
                logger.error("audio extraction failed: %s", proc.stderr[-500:])
                return None
            return str(out_path)
        except (OSError, subprocess.SubprocessError) as e:
            logger.error("Audio extraction failed: %s", e)
            return None

    # ------------------------------------------------------------------
    async def get_video_with_detections(
        self, video_id: int, db: Database
    ) -> Optional[Dict[str, Any]]:
        """Join video + frames + detections (video_service.py:124-147)."""
        video = VideoCRUD.get(db, video_id)
        if not video:
            return None
        frames = FrameCRUD.get_by_video(db, video_id)
        for frame in frames:
            frame["text_detections"] = TextDetectionCRUD.get_by_frame(
                db, frame["id"]
            )
        video["frames"] = frames
        video["processing_jobs"] = ProcessingJobCRUD.get_by_video(db, video_id)
        return video

    # ------------------------------------------------------------------
    async def validate_video(self, video_path: str) -> Dict[str, Any]:
        """Validation with warnings (video_service.py:149-183)."""
        result: Dict[str, Any] = {"valid": False, "errors": [], "warnings": []}
        if not os.path.exists(video_path):
            result["errors"].append("File does not exist")
            return result
        info = self.processor.get_video_info(video_path)
        if not info:
            result["errors"].append("Cannot read video file")
            return result
        result["metadata"] = info
        if info.get("duration", 0) <= 0:
            result["errors"].append("Invalid duration")
        if info.get("duration", 0) > 600:
            result["warnings"].append("Video longer than 10 minutes")
        if max(info.get("width", 0), info.get("height", 0)) > 4096:
            result["warnings"].append("Resolution above 4096px")
        if info.get("fps", 0) > 60:
            result["warnings"].append("Frame rate above 60 fps")
        result["valid"] = not result["errors"]
        return result
