"""Worker tasks: video processing, temp cleanup, health check (port of
``vtd_tpu/serve/tasks.py``).

Behavior parity with reference ``app/tasks/video_processing.py``:
process-wide singleton pipeline (models load once per worker, :32-37),
S3 pull to tempfile (:87-97), per-config threshold/batch overrides
(:102-103), progress flowing to both the DB job row and the task state
(:105-127), frame + detection bulk persistence keyed by frame mapping
(:169-216), and completed/failed job transitions.

The pipeline falls back to the CRNN recognizer when no transformer
checkpoint is configured (the reference default downloads TrOCR from
the HF hub, which a deployment without egress cannot do); per-job
``use_transformer`` switches engines when transformer weights exist.
Pipelines are built on ``settings.device`` (``"cuda"``) unless
``configure_pipeline(device=...)`` names another; a pipeline that cannot
get its device raises, and the job is recorded as failed.
"""
from __future__ import annotations

import asyncio
import logging
import os
import tempfile
import threading
from datetime import datetime, timezone
from typing import Any, Dict, Optional

from ..core.config import settings
from .db import (
    FrameCreate,
    FrameCRUD,
    ModelVersionCRUD,
    ProcessingJobCRUD,
    ProcessingJobUpdate,
    TextDetectionCreate,
    TextDetectionCRUD,
    VideoCRUD,
    get_database,
)
from .queue import task_queue
from .services.storage_service import StorageService

logger = logging.getLogger(__name__)

# Process-wide singletons (tasks/video_processing.py:32-37): models load
# once per worker process and are reused across jobs. Keyed by
# (use_transformer, active detector version id, active recognizer
# version id) so activating a new registry row serves the new
# checkpoint on the next job without a worker restart.
_pipelines: Dict[Any, Any] = {}
_pipeline_kwargs: Dict[str, Any] = {}
# Two worker threads asking for a pipeline that is not built yet build
# it once: the second waits for the first.
_pipelines_lock = threading.Lock()
storage_service = StorageService()

#: model registry model_type values the pipeline consults
DETECTOR_TYPE = "detector"
RECOGNIZER_TYPE = "recognizer"
RECOGNIZER_TRANSFORMER_TYPE = "recognizer_transformer"


def _active_model_versions(use_transformer: bool) -> Dict[str, Any]:
    """Active model-registry rows whose checkpoint files exist, keyed
    by role ('detector'/'recognizer'). A missing table, no active row,
    or a dangling file_path falls back to the standard locations — the
    registry must never block serving."""
    out: Dict[str, Any] = {}
    try:
        db = get_database()
        det = ModelVersionCRUD.get_active(db, DETECTOR_TYPE)
        rec = ModelVersionCRUD.get_active(
            db,
            RECOGNIZER_TRANSFORMER_TYPE if use_transformer
            else RECOGNIZER_TYPE,
        )
    except Exception as e:  # noqa: BLE001
        logger.warning("model registry unavailable: %s", e)
        return out
    for role, row in (("detector", det), ("recognizer", rec)):
        if not row:
            continue
        if not os.path.exists(row["file_path"]):
            logger.warning(
                "active %s version %s points at missing checkpoint %s; "
                "falling back to standard location",
                role, row["version"], row["file_path"],
            )
            continue
        out[role] = row
    return out


def configure_pipeline(**kwargs) -> None:
    """Set construction kwargs for worker pipelines (e.g. model paths,
    small sizes in tests). Clears any cached pipelines."""
    _pipeline_kwargs.clear()
    _pipeline_kwargs.update(kwargs)
    _pipelines.clear()


def check_settings() -> None:
    """Raise NotImplementedError for ``data_parallel_chips > 0``: its
    path comes with the port's multi-GPU slice, and serving must not
    quietly run on one card."""
    # env vars arrive as strings; "0" must not enable the mesh
    if int(settings.data_parallel_chips or 0) > 0:
        raise NotImplementedError(
            "data_parallel_chips > 0 waits for the port's multi-GPU slice "
            "(ROADMAP queue 1 item 7)"
        )


def get_pipeline(use_transformer: bool = False):
    check_settings()
    # Active registry rows override the standard checkpoint locations
    # (the reference's model_versions table is never read; here the
    # active version is the serving contract).
    active = _active_model_versions(use_transformer)

    # The transformer recognizer needs trained weights to be useful and
    # there is no hub download in a zero-egress deployment; without a
    # configured checkpoint (an active registry row, the
    # ``transformer_path`` kwarg, or the standard
    # ``<model_path>/text_recognizer_trocr`` location, as written by
    # train.trocr_trainer), fall back to the CRNN engine.
    trocr_ckpt = (
        (active.get("recognizer") or {}).get("file_path")
        if use_transformer else None
    ) or _pipeline_kwargs.get("transformer_path") or os.path.join(
        settings.model_path, "text_recognizer_trocr"
    )
    if use_transformer and not os.path.exists(trocr_ckpt):
        logger.warning(
            "transformer recognizer requested but no checkpoint at %s;"
            " using CRNN", trocr_ckpt,
        )
        use_transformer = False
        active = _active_model_versions(use_transformer)

    key = (
        use_transformer,
        (active.get("detector") or {}).get("id"),
        (active.get("recognizer") or {}).get("id"),
    )
    with _pipelines_lock:
        if key not in _pipelines:
            _pipelines[key] = _build_pipeline(use_transformer, active,
                                              trocr_ckpt)
        return _pipelines[key]


def _build_pipeline(use_transformer, active, trocr_ckpt):
    """One VideoTextPipeline for ``get_pipeline`` (under its lock)."""
    from ..runtime.pipeline import VideoTextPipeline

    # Drop stale builds of the same engine (superseded versions):
    # the worker keeps at most one pipeline per engine flavor.
    for k in [k for k in _pipelines if k[0] == use_transformer]:
        del _pipelines[k]

    kwargs = dict(_pipeline_kwargs)
    kwargs.pop("transformer_path", None)
    kwargs["use_transformer_ocr"] = use_transformer
    kwargs.setdefault("device", settings.device)
    if settings.profile_trace_dir:
        kwargs.setdefault("profile_dir", settings.profile_trace_dir)
    # Checkpoint resolution order: active registry row, explicit
    # configure_pipeline kwarg, then the standard location under
    # settings.model_path (the reference loads
    # {model_path}/text_detector.pth etc. and its health check
    # requires them, health.py:188). Without trained weights the
    # pipeline would run randomly-initialized models and emit
    # noise, so wire them whenever present.
    if "detector" in active:
        kwargs["detector_path"] = active["detector"]["file_path"]
    if "recognizer" in active and not use_transformer:
        kwargs["recognizer_path"] = active["recognizer"]["file_path"]
    det_ckpt = os.path.join(settings.model_path, "text_detector")
    if os.path.exists(det_ckpt):
        kwargs.setdefault("detector_path", det_ckpt)
    if use_transformer:
        kwargs["recognizer_path"] = trocr_ckpt
    else:
        rec_ckpt = os.path.join(settings.model_path, "text_recognizer")
        if os.path.exists(rec_ckpt):
            kwargs.setdefault("recognizer_path", rec_ckpt)
    pipeline = VideoTextPipeline(**kwargs)
    # Which registry versions (if any) this pipeline serves —
    # recorded into each job's result_data for provenance.
    pipeline.model_versions = {
        role: {
            "id": row["id"], "name": row["name"],
            "version": row["version"],
        }
        for role, row in active.items()
    }
    return pipeline


@task_queue.task(name="process_video_task", queue="video_processing")
def process_video_task(self, video_id: int, config: Dict[str, Any]):
    db = get_database()
    local_video_path: Optional[str] = None
    task_id = self.id

    ProcessingJobCRUD.update_by_task_id(
        db, task_id, ProcessingJobUpdate(status="processing")
    )
    try:
        video = VideoCRUD.get(db, video_id)
        if not video:
            raise ValueError(f"Video {video_id} not found")

        if video["file_path"].startswith("s3://"):
            fd, local_video_path = tempfile.mkstemp(suffix=".mp4")
            os.close(fd)
            asyncio.run(
                storage_service.retrieve_video(
                    video["file_path"], local_video_path
                )
            )
            video_path = local_video_path
        else:
            video_path = video["file_path"]

        if not os.path.exists(video_path):
            raise ValueError(f"Video file not found: {video_path}")

        pipeline = get_pipeline(bool(config.get("use_transformer", False)))
        # Per-call knobs, NOT mutations of the shared singleton: two
        # concurrent jobs with different thresholds must not race.
        confidence_threshold = config.get(
            "confidence_threshold", settings.confidence_threshold
        )
        min_rec_conf = float(config.get("min_recognition_confidence", 0.0))
        temporal_dedup = bool(config.get("temporal_dedup", False))
        sample_mode = config.get("sample_mode") or None

        async def progress_callback(progress, processed_frames, total_frames):
            if self.is_revoked():
                raise InterruptedError("job cancelled")
            ProcessingJobCRUD.update_by_task_id(
                db,
                task_id,
                ProcessingJobUpdate(
                    progress=progress * 100,
                    processed_frames=processed_frames,
                    total_frames=total_frames,
                ),
            )
            self.update_state(
                state="PROGRESS",
                meta={
                    "progress": progress * 100,
                    "processed_frames": processed_frames,
                    "total_frames": total_frames,
                },
            )

        # Partial-progress checkpoint: a retried job resumes where the
        # previous attempt stopped instead of re-OCRing from frame 0.
        # Keyed by (video, config hash) so a rerun with a different
        # threshold/engine never resumes from another config's frames.
        os.makedirs(settings.temp_dir, exist_ok=True)
        import hashlib
        import json as _json

        config_key = hashlib.sha256(
            _json.dumps(config, sort_keys=True, default=str).encode()
        ).hexdigest()[:12]
        resume_file = os.path.join(
            settings.temp_dir,
            f"resume_video_{video_id}_{config_key}.jsonl",
        )
        results = asyncio.run(
            pipeline.process_video(
                video_path=video_path,
                output_dir=settings.output_dir,
                progress_callback=progress_callback,
                resume_file=resume_file,
                confidence_threshold=confidence_threshold,
                min_recognition_confidence=min_rec_conf,
                temporal_dedup=temporal_dedup,
                sample_mode=sample_mode,
            )
        )

        if results["status"] != "success":
            raise ValueError(
                f"Processing failed: {results.get('error', 'Unknown error')}"
            )
        if os.path.exists(resume_file):
            os.unlink(resume_file)

        # Provenance: which registry versions produced this result.
        model_versions = getattr(pipeline, "model_versions", None)
        if model_versions:
            results["model_versions"] = model_versions
        save_results_to_database(db, video_id, results)
        ProcessingJobCRUD.update_by_task_id(
            db,
            task_id,
            ProcessingJobUpdate(
                status="completed", progress=100.0, result_data=results
            ),
        )
        return {
            "status": "success",
            "video_id": video_id,
            "results": results["summary"],
            "total_detections": results["summary"]["total_detections"],
        }

    except InterruptedError:
        ProcessingJobCRUD.update_by_task_id(
            db, task_id, ProcessingJobUpdate(status="cancelled")
        )
        raise
    except Exception as e:
        logger.error("Video processing failed for video %s: %s", video_id, e)
        ProcessingJobCRUD.update_by_task_id(
            db,
            task_id,
            ProcessingJobUpdate(status="failed", error_message=str(e)),
        )
        raise
    finally:
        if local_video_path and os.path.exists(local_video_path):
            os.unlink(local_video_path)


def save_results_to_database(db, video_id: int, results: Dict[str, Any]):
    """Bulk-persist frames then detections (tasks/video_processing.py:169-216)."""
    frame_creates = []
    for fr in results["results"]:
        frame_creates.append(
            FrameCreate(
                video_id=video_id,
                frame_number=fr["frame_number"],
                timestamp=fr["timestamp"],
                file_path=f"frame_{fr['frame_number']:04d}.jpg",
                width=results["video_info"].get("width", 640),
                height=results["video_info"].get("height", 480),
            )
        )
    created = FrameCRUD.create_bulk(db, frame_creates)
    frame_map = {f["frame_number"]: f["id"] for f in created}

    # Detection rows carry the serving detector's registry identity
    # when one is active; the reference hardcodes its model fields the
    # same way this falls back.
    det_mv = (results.get("model_versions") or {}).get("detector") or {}
    model_name = det_mv.get("name", "DBNet-CRNN")
    model_version = det_mv.get("version", "1.0.0")
    detection_creates = []
    for fr in results["results"]:
        frame_id = frame_map[fr["frame_number"]]
        for det in fr["detections"]:
            detection_creates.append(
                TextDetectionCreate(
                    frame_id=frame_id,
                    text_content=det["text"],
                    confidence=det["detection_confidence"],
                    bbox_x1=det["bbox"][0],
                    bbox_y1=det["bbox"][1],
                    bbox_x2=det["bbox"][2],
                    bbox_y2=det["bbox"][3],
                    model_name=model_name,
                    model_version=model_version,
                )
            )
    if detection_creates:
        TextDetectionCRUD.create_bulk(db, detection_creates)
    logger.info(
        "Saved %d frames and %d detections", len(created), len(detection_creates)
    )


@task_queue.task(name="cleanup_temp_files", queue="maintenance")
def cleanup_temp_files_task(self):
    removed = StorageService.cleanup_temp_files(max_age_hours=24)
    logger.info("Temp cleanup removed %d files", removed)
    return removed


@task_queue.task(name="health_check_task", queue="monitoring")
def health_check_task(self):
    return {
        "status": "healthy",
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "worker_id": os.getenv("HOSTNAME", "unknown"),
    }


def register_beat_schedule() -> None:
    """Beat parity (celery_app.py:35-44): hourly temp cleanup, 5-minute
    health check."""
    task_queue.add_periodic_task(3600.0, cleanup_temp_files_task)
    task_queue.add_periodic_task(300.0, health_check_task)
