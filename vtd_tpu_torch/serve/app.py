"""REST application (port of ``vtd_tpu/serve/app.py``) — /api/v1
surface parity with the reference.

Routes (reference ``app/api/__init__.py`` + endpoint modules):
  POST /api/v1/auth/register, /auth/login, /auth/refresh; GET /auth/me
  POST /api/v1/videos/upload; GET /videos/, /videos/{id},
       /videos/{id}/download, /videos/{id}/thumbnail;
       PUT/DELETE /videos/{id}
  POST /api/v1/processing/videos/{id}/detect, /jobs/{id}/cancel;
       GET /jobs/{id}, /jobs/{id}/status, /videos/{id}/results,
       /videos/{id}/annotated
  GET /, /health, /metrics

Middleware order matches ``app/main.py:75-79``:
Error -> Security -> CORS -> RateLimit -> Logging (outermost first).

``main`` (``python -m vtd_tpu_torch serve``) serves on the card: without
CUDA it exits non-zero unless ``--device cpu`` is given.
"""
from __future__ import annotations

import asyncio
import logging
import os
import threading
import uuid
from datetime import datetime
from pathlib import Path
from typing import Any, Dict

from ..core.config import settings
from .auth import create_access_token, get_current_active_user, get_current_user
from .db import (
    ModelVersionCreate,
    ModelVersionCRUD,
    ProcessingJobCreate,
    ProcessingJobCRUD,
    UserCreate,
    UserCRUD,
    VideoCreate,
    VideoCRUD,
    VideoUpdate,
    get_database,
    init_db,
)
from .http import App, FileResponse, HTTPException, Request, Response
from .middleware import (
    cors_middleware,
    error_handling_middleware,
    logging_middleware,
    make_rate_limit_middleware,
    security_headers_middleware,
)
from .queue import task_queue
from .services import ProcessingService, StorageService, VideoService
from .tasks import process_video_task, register_beat_schedule

logger = logging.getLogger(__name__)


def _run(coro):
    return asyncio.run(coro)


def _register_queue_metrics():
    """Worker-signal metric hooks (parity: the reference's Celery signal
    handlers exporting task counters/durations, celery_app.py:54-105)."""
    from ..obs.metrics import metrics_collector

    def on_postrun(rec):
        duration = (rec.finished_at or 0) - (rec.started_at or 0)
        metrics_collector.record_task(rec.name, rec.state, max(duration, 0))
        if rec.name == "process_video_task" and rec.state == "SUCCESS":
            metrics_collector.record_processing_duration(max(duration, 0))
            result = rec.result or {}
            metrics_collector.record_text_detections(
                int(result.get("total_detections", 0))
            )

    def on_prerun(rec):
        metrics_collector.set_active_jobs(
            len(
                [
                    r
                    for r in task_queue.records.values()
                    if r.state in ("STARTED", "PROGRESS")
                ]
            )
        )

    def on_failure(rec, exc):
        # Queue-level terminal failures (hard time limit, process worker
        # lost/SIGKILLed) never run the task's own except-clause, so the
        # processing_jobs row would stay 'processing' forever and 409
        # every future detect on that video — sync it here.
        if rec.name != "process_video_task":
            return
        from .db.database import get_database
        from .db.schemas import ProcessingJobUpdate

        db = get_database()
        job = ProcessingJobCRUD.get_by_task_id(db, rec.id)
        if job and job["status"] not in (
            "completed", "failed", "cancelled"
        ):
            ProcessingJobCRUD.update_by_task_id(
                db, rec.id,
                ProcessingJobUpdate(
                    status="failed", error_message=str(rec.result or exc)
                ),
            )

    # identity check on a fresh closure is always True — guard with a
    # flag so repeated create_app calls in one process don't stack hooks
    # (stacked postruns double-count every task metric)
    if not getattr(task_queue, "_app_hooks_registered", False):
        task_queue._app_hooks_registered = True
        task_queue.on_postrun.append(on_postrun)
        task_queue.on_prerun.append(on_prerun)
        task_queue.on_failure.append(on_failure)


def _public_user(user: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in user.items() if k != "hashed_password"}


def create_app(
    start_worker: bool = True, rate_limit_store=None, storage_service=None
) -> App:
    """``storage_service`` injects a pre-built StorageService (tests
    pass one wired to a stub S3 client); None builds from settings."""
    app = App()
    video_service = VideoService()
    storage_service = storage_service or StorageService()
    processing_service = ProcessingService()

    def startup():
        """Lifespan parity (app/main.py:40-64)."""
        init_db()
        for d in (settings.temp_dir, settings.output_dir, settings.model_path):
            os.makedirs(d, exist_ok=True)
        if start_worker:
            register_beat_schedule()
            _register_queue_metrics()
        from ..obs.metrics import metrics_collector

        metrics_collector.set_app_info(
            {"app_name": settings.app_name, "version": settings.version}
        )
        logger.info("Video Text Detection API started")

    app.on_startup.append(startup)

    # middleware: innermost-added-first => add in reverse of reference order
    app.add_middleware(logging_middleware)
    if rate_limit_store is None:
        from .middleware import make_window_store

        rate_limit_store = make_window_store(settings.rate_limit_store_url)
    app.add_middleware(make_rate_limit_middleware(rate_limit_store))
    app.add_middleware(cors_middleware)
    app.add_middleware(security_headers_middleware)
    app.add_middleware(error_handling_middleware)

    # -- root & health (app/main.py:87-106) -------------------------------
    @app.get("/")
    def root(request: Request) -> Response:
        return Response(
            200,
            {
                "service": settings.app_name,
                "version": settings.version,
                "status": "healthy",
            },
        )

    @app.get("/health")
    def health(request: Request) -> Response:
        import time as _time

        db_status = get_database().health_check()
        return Response(
            200,
            {
                "status": "healthy"
                if db_status["status"] == "healthy"
                else "unhealthy",
                "version": settings.version,
                "database": db_status,
                "timestamp": _time.time(),
            },
        )

    @app.get("/health/detailed")
    def health_detailed(request: Request) -> Response:
        from ..obs.health import health_monitor

        return Response(200, _run(health_monitor.get_health()))

    @app.get("/health/ready")
    def health_ready(request: Request) -> Response:
        from ..obs.health import health_monitor

        body = _run(health_monitor.readiness())
        return Response(200 if body["ready"] else 503, body)

    @app.get("/health/live")
    def health_live(request: Request) -> Response:
        from ..obs.health import health_monitor

        body = _run(health_monitor.liveness())
        return Response(200 if body["alive"] else 503, body)

    # -- metrics (prometheus mount, app/main.py:83-85) ---------------------
    if settings.enable_metrics:
        def metrics_handler(request: Request) -> Response:
            from ..obs.metrics import generate_latest

            return Response(
                200, None, {}, "text/plain; version=0.0.4",
                body_bytes=generate_latest(),
            )

        app.mount("/metrics", metrics_handler)

    # -- web UI (frontend parity: app/frontend/main.py) --------------------
    @app.get("/app")
    def webapp(request: Request) -> Response:
        import secrets

        from ..frontend.webapp import render_index

        # Per-request CSP nonce: the SPA's single <style>/<script> carry
        # it, so `default-src 'self'` stays strict without breaking the UI
        # (the reference's CSP guarded an API-only service).
        nonce = secrets.token_urlsafe(16)
        resp = Response(
            200, render_index(nonce), media_type="text/html; charset=utf-8"
        )
        resp.headers["Content-Security-Policy"] = (
            f"default-src 'self'; script-src 'nonce-{nonce}'; "
            f"style-src 'nonce-{nonce}'; img-src 'self' data:"
        )
        return resp

    # ======================= auth =========================================
    @app.post("/api/v1/auth/register")
    def register(request: Request) -> Response:
        db = get_database()
        try:
            user = UserCreate(**request.json())
        except Exception as e:
            raise HTTPException(422, f"Invalid user payload: {e}")
        if UserCRUD.get_by_email(db, user.email):
            raise HTTPException(400, "Email already registered")
        if UserCRUD.get_by_username(db, user.username):
            raise HTTPException(400, "Username already taken")
        created = UserCRUD.create(db, user)
        token = create_access_token({"sub": created["username"]})
        return Response(
            201, {"access_token": token, "token_type": "bearer"}
        )

    @app.post("/api/v1/auth/login")
    def login(request: Request) -> Response:
        form = request.form()
        user = UserCRUD.authenticate(
            get_database(), form.get("username", ""), form.get("password", "")
        )
        if not user:
            raise HTTPException(
                401,
                "Incorrect username or password",
                headers={"WWW-Authenticate": "Bearer"},
            )
        token = create_access_token({"sub": user["username"]})
        return Response(200, {"access_token": token, "token_type": "bearer"})

    @app.get("/api/v1/auth/me")
    def me(request: Request) -> Response:
        user = get_current_active_user(request)
        return Response(200, _public_user(user))

    @app.post("/api/v1/auth/refresh")
    def refresh(request: Request) -> Response:
        user = get_current_user(request)
        token = create_access_token({"sub": user["username"]})
        return Response(200, {"access_token": token, "token_type": "bearer"})

    # ======================= videos =======================================
    @app.post("/api/v1/videos/upload")
    def upload_video(request: Request) -> Response:
        user = get_current_active_user(request)
        db = get_database()
        files = request.files()
        if "file" not in files or not files["file"][0]:
            raise HTTPException(400, "No file provided")
        filename, content = files["file"]
        category = request.query.get("category") or request.form().get(
            "category"
        )

        ext = Path(filename).suffix.lower()
        if ext not in [f".{f}" for f in settings.supported_formats]:
            raise HTTPException(
                400,
                f"Unsupported file format. Supported: {settings.supported_formats}",
            )
        if len(content) > settings.max_file_size:
            raise HTTPException(
                413,
                f"File too large. Maximum size: {settings.max_file_size} bytes",
            )

        unique_filename = f"{uuid.uuid4()}{ext}"
        os.makedirs(settings.temp_dir, exist_ok=True)
        tmp_path = Path(settings.temp_dir) / unique_filename
        try:
            content.save_to(str(tmp_path))
            video_info = _run(video_service.get_video_metadata(str(tmp_path)))
            if video_info.get("duration", 0) > settings.max_video_duration:
                raise HTTPException(
                    413,
                    f"Video too long. Maximum duration: {settings.max_video_duration} seconds",
                )
            final_path = _run(
                storage_service.store_video(str(tmp_path), unique_filename)
            )
            video = VideoCRUD.create(
                db,
                VideoCreate(
                    filename=unique_filename,
                    original_filename=filename,
                    file_path=final_path,
                    file_size=len(content),
                    category=category,
                ),
                owner_id=user["id"],
            )
            if video_info:
                video = VideoCRUD.update(
                    db,
                    video["id"],
                    VideoUpdate(
                        duration=video_info.get("duration"),
                        fps=video_info.get("fps"),
                        width=video_info.get("width"),
                        height=video_info.get("height"),
                    ),
                )
            return Response(201, video)
        except HTTPException:
            raise
        except Exception as e:
            raise HTTPException(500, f"Upload failed: {e}")
        finally:
            if tmp_path.exists():
                os.remove(tmp_path)

    @app.get("/api/v1/videos/")
    def list_videos(request: Request) -> Response:
        user = get_current_active_user(request)
        skip = int(request.query.get("skip", 0))
        limit = int(request.query.get("limit", 100))
        return Response(
            200, VideoCRUD.get_by_user(get_database(), user["id"], skip, limit)
        )

    def _owned_video(request: Request, video_id: str) -> Dict[str, Any]:
        user = get_current_active_user(request)
        video = VideoCRUD.get(get_database(), int(video_id))
        if not video:
            raise HTTPException(404, "Video not found")
        if video["owner_id"] != user["id"]:
            raise HTTPException(403, "Not enough permissions")
        return video

    @app.get("/api/v1/videos/{video_id}")
    def get_video(request: Request) -> Response:
        video = _owned_video(request, request.path_params["video_id"])
        if request.query.get("include_detections") in ("true", "True", "1"):
            full = _run(
                video_service.get_video_with_detections(
                    video["id"], get_database()
                )
            )
            return Response(200, full)
        return Response(200, video)

    @app.put("/api/v1/videos/{video_id}")
    def update_video(request: Request) -> Response:
        video = _owned_video(request, request.path_params["video_id"])
        try:
            update = VideoUpdate(**request.json())
        except Exception as e:
            raise HTTPException(422, f"Invalid update payload: {e}")
        return Response(
            200, VideoCRUD.update(get_database(), video["id"], update)
        )

    @app.delete("/api/v1/videos/{video_id}")
    def delete_video(request: Request) -> Response:
        video = _owned_video(request, request.path_params["video_id"])
        _run(storage_service.delete_video(video["file_path"]))
        VideoCRUD.delete(get_database(), video["id"])
        return Response(204, None)

    # Per-video locks so concurrent requests for the same uncached S3
    # video fetch once; the download lands under a temp name and is
    # os.rename'd into place so a reader can never see a partial file.
    _s3cache_locks: Dict[str, threading.Lock] = {}
    _s3cache_locks_guard = threading.Lock()

    def _local_video_path(video: Dict[str, Any]) -> str:
        """file_path usable by os/cv2/ffmpeg: S3-stored videos (the
        worker task already pulls them the same way) are fetched to a
        per-video temp cache; local paths pass through."""
        path = video["file_path"]
        if not path.startswith("s3://"):
            return path
        ext = os.path.splitext(video["original_filename"])[1] or ".mp4"
        cached = os.path.join(
            settings.temp_dir, f"s3cache_{video['id']}{ext}"
        )
        if os.path.exists(cached):
            return cached
        with _s3cache_locks_guard:
            lock = _s3cache_locks.setdefault(
                str(video["id"]), threading.Lock()
            )
        with lock:
            if not os.path.exists(cached):
                os.makedirs(settings.temp_dir, exist_ok=True)
                tmp = f"{cached}.dl{os.getpid()}.{threading.get_ident()}"
                try:
                    _run(storage_service.retrieve_video(path, tmp))
                    os.rename(tmp, cached)  # atomic on POSIX
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        return cached

    @app.get("/api/v1/videos/{video_id}/download")
    def download_video(request: Request) -> Response:
        video = _owned_video(request, request.path_params["video_id"])
        path = _local_video_path(video)
        if not os.path.exists(path):
            raise HTTPException(404, "Video file not found")
        return FileResponse(path, filename=video["original_filename"])

    @app.get("/api/v1/videos/{video_id}/thumbnail")
    def video_thumbnail(request: Request) -> Response:
        video = _owned_video(request, request.path_params["video_id"])
        ts = float(request.query.get("timestamp", 0.0))
        thumb = _run(
            video_service.generate_thumbnail(_local_video_path(video), ts)
        )
        if not thumb or not os.path.exists(thumb):
            raise HTTPException(404, "Thumbnail generation failed")
        return FileResponse(thumb, media_type="image/jpeg")

    # ======================= processing ====================================
    @app.post("/api/v1/processing/videos/{video_id}/detect")
    def start_detection(request: Request) -> Response:
        video = _owned_video(request, request.path_params["video_id"])
        db = get_database()
        if ProcessingJobCRUD.get_active_for_video(db, video["id"]):
            raise HTTPException(409, "Video is already being processed")

        q = request.query
        task_config = {
            "confidence_threshold": float(
                q.get("confidence_threshold") or settings.confidence_threshold
            ),
            # OCR-confidence output filter; 0.0 = reference parity
            # (the reference's hardcoded 0.95 confidence never filters).
            "min_recognition_confidence": float(
                q.get("min_recognition_confidence") or 0.0
            ),
            "use_transformer": q.get("use_transformer", "true").lower()
            in ("true", "1"),
            "temporal_dedup": q.get("temporal_dedup", "false").lower()
            in ("true", "1"),
            # 'keyframe' processes only scene-change frames and
            # propagates their detections to near-duplicate candidates.
            "sample_mode": (
                "keyframe"
                if q.get("sample_mode", "stride").lower() == "keyframe"
                else "stride"
            ),
            "batch_size": settings.batch_size,
        }
        # Persist the job row BEFORE the task can run: with the
        # in-process worker the task may start (and try to update the
        # row by task id) microseconds after submission — pre-generating
        # the id closes the race where a fast-failing task's updates
        # no-op and the row stays 'pending' forever, 409-blocking the
        # video. (Celery's apply_async(task_id=...) contract.)
        import uuid as _uuid

        task_id = str(_uuid.uuid4())
        job = ProcessingJobCRUD.create(
            db,
            ProcessingJobCreate(video_id=video["id"], celery_task_id=task_id),
        )
        process_video_task.apply_async(
            args=(video["id"], task_config), task_id=task_id
        )
        return Response(200, job)

    def _owned_job(request: Request, job_id: str) -> Dict[str, Any]:
        user = get_current_active_user(request)
        db = get_database()
        job = ProcessingJobCRUD.get(db, int(job_id))
        if not job:
            raise HTTPException(404, "Job not found")
        video = VideoCRUD.get(db, job["video_id"])
        if not video or video["owner_id"] != user["id"]:
            raise HTTPException(403, "Not enough permissions")
        return job

    @app.get("/api/v1/processing/jobs/{job_id}")
    def get_job(request: Request) -> Response:
        return Response(200, _owned_job(request, request.path_params["job_id"]))

    @app.get("/api/v1/processing/jobs/{job_id}/status")
    def job_status(request: Request) -> Response:
        job = _owned_job(request, request.path_params["job_id"])
        task_result = processing_service.get_task_status(
            job["celery_task_id"]
        )
        return Response(
            200,
            {
                "job_id": job["id"],
                "status": job["status"],
                "progress": job["progress"],
                "processed_frames": job["processed_frames"],
                "total_frames": job["total_frames"],
                "celery_status": task_result.get("status"),
                "celery_info": task_result.get("info", {}),
                "started_at": job["started_at"],
                "completed_at": job["completed_at"],
                "error_message": job["error_message"],
            },
        )

    @app.post("/api/v1/processing/jobs/{job_id}/cancel")
    def cancel_job(request: Request) -> Response:
        job = _owned_job(request, request.path_params["job_id"])
        if job["status"] not in ("pending", "processing"):
            raise HTTPException(
                409, f"Cannot cancel job with status: {job['status']}"
            )
        from .db import ProcessingJobUpdate

        if processing_service.cancel_task(job["celery_task_id"]):
            ProcessingJobCRUD.update(
                get_database(), job["id"],
                ProcessingJobUpdate(status="cancelled"),
            )
            return Response(200, {"message": "Job cancelled successfully"})
        raise HTTPException(500, "Failed to cancel job")

    @app.get("/api/v1/processing/videos/{video_id}/results")
    def video_results(request: Request) -> Response:
        video = _owned_video(request, request.path_params["video_id"])
        db = get_database()
        job = ProcessingJobCRUD.get_latest_completed(db, video["id"])
        if not job or not job.get("result_data"):
            raise HTTPException(404, "No completed processing results found")
        fmt = request.query.get("format", "json")
        if fmt == "csv":
            content = _run(
                processing_service.export_results_csv(job["result_data"])
            )
            return Response(200, {"format": "csv", "content": content})
        if fmt == "xml":
            content = _run(
                processing_service.export_results_xml(job["result_data"])
            )
            return Response(200, {"format": "xml", "content": content})
        return Response(
            200,
            {
                "format": "json",
                "results": job["result_data"],
                "summary": job["result_data"].get("summary", {}),
            },
        )

    @app.get("/api/v1/processing/videos/{video_id}/annotated")
    def annotated_video(request: Request) -> Response:
        video = _owned_video(request, request.path_params["video_id"])
        db = get_database()
        job = ProcessingJobCRUD.get_latest_completed(db, video["id"])
        if not job:
            raise HTTPException(404, "No completed processing found")
        path = _run(
            processing_service.create_annotated_video(
                _local_video_path(video), job.get("result_data") or {}
            )
        )
        if not path or not os.path.exists(path):
            raise HTTPException(404, "Annotated video not available")
        return FileResponse(
            path,
            filename=f"annotated_{video['original_filename']}",
            media_type="video/mp4",
        )

    # ======================= model registry ================================
    # The reference defines the model_versions table but never reads it
    # (reference app/database/models.py:122-136, crud.py:135-158 — dead
    # code). Here the registry is WIRED: the active row per model_type
    # picks the checkpoint a worker pipeline loads (serve/tasks.py
    # get_pipeline), and these admin endpoints manage it.
    @app.get("/api/v1/models")
    def list_model_versions(request: Request) -> Response:
        get_current_active_user(request)
        mt = request.query.get("model_type")
        return Response(
            200, ModelVersionCRUD.get_all(get_database(), mt)
        )

    @app.post("/api/v1/models")
    def register_model_version(request: Request) -> Response:
        get_current_active_user(request)
        try:
            mv = ModelVersionCreate(**request.json())
        except Exception as e:
            raise HTTPException(422, f"Invalid model version payload: {e}")
        return Response(201, ModelVersionCRUD.create(get_database(), mv))

    @app.post("/api/v1/models/{model_id}/activate")
    def activate_model_version(request: Request) -> Response:
        get_current_active_user(request)
        mv = ModelVersionCRUD.set_active(
            get_database(), int(request.path_params["model_id"])
        )
        if not mv:
            raise HTTPException(404, "Model version not found")
        return Response(200, mv)

    return app


def main(argv=None) -> int:
    """``python -m vtd_tpu_torch serve`` — run the API server on the
    card (``--device cuda``, the default) or, when asked, on the CPU."""
    import argparse
    import sys

    from .http import Server
    from .tasks import check_settings

    parser = argparse.ArgumentParser(prog="vtd_tpu_torch serve")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default=settings.device,
                        choices=["cuda", "cpu"],
                        help="where job pipelines run (default cuda)")
    args = parser.parse_args(argv)

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("serve: CUDA is not available; the service runs on the "
                  "card unless --device cpu is given", file=sys.stderr)
            return 2
    try:
        check_settings()
    except NotImplementedError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    settings.device = args.device
    os.environ["DEVICE"] = args.device  # what pool children read

    from ..obs.logging import configure_logging

    configure_logging()  # structured JSON logs (app/main.py:20-35 parity)
    app = create_app()
    server = Server(app, args.host, args.port)
    logger.info("Serving on %s:%d (device %s)", args.host, server.port,
                args.device)
    server.serve_forever()
    return 0
