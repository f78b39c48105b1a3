"""CRUD repositories — class/method parity with reference
``app/database/crud.py`` (static-method UserCRUD/VideoCRUD/FrameCRUD/
TextDetectionCRUD/ProcessingJobCRUD/ModelVersionCRUD), over sqlite3.

Port of ``vtd_tpu/serve/db/crud.py``. Password hashing uses stdlib
``hashlib.scrypt`` with per-user random salt, constant-time compare.
Rows are returned as plain dicts with JSON columns decoded.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from . import schemas
from .database import Database

_SCRYPT_N, _SCRYPT_R, _SCRYPT_P = 2 ** 14, 8, 1


def get_password_hash(password: str) -> str:
    salt = os.urandom(16)
    dk = hashlib.scrypt(
        password.encode(), salt=salt, n=_SCRYPT_N, r=_SCRYPT_R, p=_SCRYPT_P
    )
    return "scrypt$" + base64.b64encode(salt).decode() + "$" + base64.b64encode(dk).decode()


def verify_password(plain_password: str, hashed_password: str) -> bool:
    try:
        scheme, salt_b64, dk_b64 = hashed_password.split("$")
        if scheme != "scrypt":
            return False
        salt = base64.b64decode(salt_b64)
        expected = base64.b64decode(dk_b64)
        dk = hashlib.scrypt(
            plain_password.encode(), salt=salt,
            n=_SCRYPT_N, r=_SCRYPT_R, p=_SCRYPT_P,
        )
        return hmac.compare_digest(dk, expected)
    except (ValueError, TypeError):
        return False


def _now() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")


def _decode_json_fields(row: Optional[Dict[str, Any]], *fields: str):
    if row is None:
        return None
    for f in fields:
        if row.get(f) and isinstance(row[f], str):
            try:
                row[f] = json.loads(row[f])
            except ValueError:
                pass
    return row


class UserCRUD:
    @staticmethod
    def get(db: Database, user_id: int) -> Optional[Dict[str, Any]]:
        return db.query_one("SELECT * FROM users WHERE id = ?", (user_id,))

    @staticmethod
    def get_by_email(db: Database, email: str) -> Optional[Dict[str, Any]]:
        return db.query_one("SELECT * FROM users WHERE email = ?", (email,))

    @staticmethod
    def get_by_username(db: Database, username: str) -> Optional[Dict[str, Any]]:
        return db.query_one(
            "SELECT * FROM users WHERE username = ?", (username,)
        )

    @staticmethod
    def create(db: Database, user: schemas.UserCreate) -> Dict[str, Any]:
        uid = db.insert(
            "users",
            {
                "email": user.email,
                "username": user.username,
                "hashed_password": get_password_hash(user.password),
                "is_active": True,
            },
        )
        return UserCRUD.get(db, uid)

    @staticmethod
    def authenticate(
        db: Database, username: str, password: str
    ) -> Optional[Dict[str, Any]]:
        user = UserCRUD.get_by_username(db, username)
        if not user or not verify_password(password, user["hashed_password"]):
            return None
        return user


class VideoCRUD:
    @staticmethod
    def create(
        db: Database, video: schemas.VideoCreate, owner_id: int
    ) -> Dict[str, Any]:
        vid = db.insert(
            "videos", {**video.model_dump(), "owner_id": owner_id}
        )
        return VideoCRUD.get(db, vid)

    @staticmethod
    def get(db: Database, video_id: int) -> Optional[Dict[str, Any]]:
        return db.query_one("SELECT * FROM videos WHERE id = ?", (video_id,))

    @staticmethod
    def get_by_user(
        db: Database, user_id: int, skip: int = 0, limit: int = 100
    ) -> List[Dict[str, Any]]:
        return db.query_all(
            "SELECT * FROM videos WHERE owner_id = ? LIMIT ? OFFSET ?",
            (user_id, limit, skip),
        )

    @staticmethod
    def update(
        db: Database, video_id: int, video_update: schemas.VideoUpdate
    ) -> Optional[Dict[str, Any]]:
        data = video_update.model_dump(exclude_unset=True)
        if data:
            data["updated_at"] = _now()
            db.update("videos", video_id, data)
        return VideoCRUD.get(db, video_id)

    @staticmethod
    def delete(db: Database, video_id: int) -> bool:
        video = VideoCRUD.get(db, video_id)
        if not video:
            return False
        # cascade like the reference relationships (models.py:59-60)
        frame_ids = [
            r["id"]
            for r in db.query_all(
                "SELECT id FROM frames WHERE video_id = ?", (video_id,)
            )
        ]
        if frame_ids:
            q = ",".join("?" for _ in frame_ids)
            db.execute(
                f"DELETE FROM text_detections WHERE frame_id IN ({q})",
                frame_ids,
            )
        db.execute("DELETE FROM frames WHERE video_id = ?", (video_id,))
        db.execute(
            "DELETE FROM processing_jobs WHERE video_id = ?", (video_id,)
        )
        db.execute("DELETE FROM videos WHERE id = ?", (video_id,))
        return True


class FrameCRUD:
    @staticmethod
    def create(db: Database, frame: schemas.FrameCreate) -> Dict[str, Any]:
        fid = db.insert("frames", frame.model_dump())
        return db.query_one("SELECT * FROM frames WHERE id = ?", (fid,))

    @staticmethod
    def create_bulk(
        db: Database, frames: List[schemas.FrameCreate]
    ) -> List[Dict[str, Any]]:
        out = []
        for f in frames:
            out.append(FrameCRUD.create(db, f))
        return out

    @staticmethod
    def get_by_video(db: Database, video_id: int) -> List[Dict[str, Any]]:
        return db.query_all(
            "SELECT * FROM frames WHERE video_id = ? ORDER BY frame_number",
            (video_id,),
        )


class TextDetectionCRUD:
    @staticmethod
    def create(
        db: Database, detection: schemas.TextDetectionCreate
    ) -> Dict[str, Any]:
        did = db.insert("text_detections", detection.model_dump())
        return db.query_one(
            "SELECT * FROM text_detections WHERE id = ?", (did,)
        )

    @staticmethod
    def create_bulk(
        db: Database, detections: List[schemas.TextDetectionCreate]
    ) -> int:
        db.executemany(
            "INSERT INTO text_detections (frame_id, text_content, confidence,"
            " bbox_x1, bbox_y1, bbox_x2, bbox_y2, language, category,"
            " model_name, model_version) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            [
                (
                    d.frame_id, d.text_content, d.confidence,
                    d.bbox_x1, d.bbox_y1, d.bbox_x2, d.bbox_y2,
                    d.language, d.category, d.model_name, d.model_version,
                )
                for d in detections
            ],
        )
        return len(detections)

    @staticmethod
    def get_by_frame(db: Database, frame_id: int) -> List[Dict[str, Any]]:
        return db.query_all(
            "SELECT * FROM text_detections WHERE frame_id = ?", (frame_id,)
        )

    @staticmethod
    def get_by_video(db: Database, video_id: int) -> List[Dict[str, Any]]:
        return db.query_all(
            "SELECT td.* FROM text_detections td"
            " JOIN frames f ON td.frame_id = f.id"
            " WHERE f.video_id = ?",
            (video_id,),
        )


class ProcessingJobCRUD:
    @staticmethod
    def create(
        db: Database, job: schemas.ProcessingJobCreate
    ) -> Dict[str, Any]:
        jid = db.insert(
            "processing_jobs",
            {**job.model_dump(), "status": "pending", "progress": 0.0},
        )
        return ProcessingJobCRUD.get(db, jid)

    @staticmethod
    def get(db: Database, job_id: int) -> Optional[Dict[str, Any]]:
        return _decode_json_fields(
            db.query_one(
                "SELECT * FROM processing_jobs WHERE id = ?", (job_id,)
            ),
            "result_data",
        )

    @staticmethod
    def get_by_task_id(
        db: Database, celery_task_id: str
    ) -> Optional[Dict[str, Any]]:
        return _decode_json_fields(
            db.query_one(
                "SELECT * FROM processing_jobs WHERE celery_task_id = ?",
                (celery_task_id,),
            ),
            "result_data",
        )

    @staticmethod
    def get_by_video(db: Database, video_id: int) -> List[Dict[str, Any]]:
        rows = db.query_all(
            "SELECT * FROM processing_jobs WHERE video_id = ?"
            " ORDER BY created_at DESC",
            (video_id,),
        )
        return [_decode_json_fields(r, "result_data") for r in rows]

    @staticmethod
    def get_active_for_video(
        db: Database, video_id: int
    ) -> Optional[Dict[str, Any]]:
        return db.query_one(
            "SELECT * FROM processing_jobs WHERE video_id = ?"
            " AND status IN ('pending', 'processing') LIMIT 1",
            (video_id,),
        )

    @staticmethod
    def get_latest_completed(
        db: Database, video_id: int
    ) -> Optional[Dict[str, Any]]:
        return _decode_json_fields(
            db.query_one(
                "SELECT * FROM processing_jobs WHERE video_id = ?"
                " AND status = 'completed'"
                " ORDER BY completed_at DESC LIMIT 1",
                (video_id,),
            ),
            "result_data",
        )

    @staticmethod
    def update(
        db: Database, job_id: int, update: schemas.ProcessingJobUpdate
    ) -> Optional[Dict[str, Any]]:
        data = update.model_dump(exclude_unset=True)
        if "status" in data:
            status = data["status"]
            data["status"] = (
                status.value if hasattr(status, "value") else status
            )
            if data["status"] == "processing":
                data.setdefault("started_at", _now())
            if data["status"] in ("completed", "failed", "cancelled"):
                data.setdefault("completed_at", _now())
        db.update("processing_jobs", job_id, data)
        return ProcessingJobCRUD.get(db, job_id)

    @staticmethod
    def update_by_task_id(
        db: Database, celery_task_id: str, update: schemas.ProcessingJobUpdate
    ) -> Optional[Dict[str, Any]]:
        job = ProcessingJobCRUD.get_by_task_id(db, celery_task_id)
        if not job:
            return None
        return ProcessingJobCRUD.update(db, job["id"], update)


class ModelVersionCRUD:
    @staticmethod
    def create(
        db: Database, mv: schemas.ModelVersionCreate
    ) -> Dict[str, Any]:
        mid = db.insert("model_versions", mv.model_dump())
        return _decode_json_fields(
            db.query_one("SELECT * FROM model_versions WHERE id = ?", (mid,)),
            "config", "performance_metrics",
        )

    @staticmethod
    def get(db: Database, mv_id: int) -> Optional[Dict[str, Any]]:
        return _decode_json_fields(
            db.query_one(
                "SELECT * FROM model_versions WHERE id = ?", (mv_id,)
            ),
            "config", "performance_metrics",
        )

    @staticmethod
    def get_all(db: Database, model_type: Optional[str] = None):
        if model_type:
            rows = db.query_all(
                "SELECT * FROM model_versions WHERE model_type = ?",
                (model_type,),
            )
        else:
            rows = db.query_all("SELECT * FROM model_versions")
        return [
            _decode_json_fields(r, "config", "performance_metrics")
            for r in rows
        ]

    @staticmethod
    def get_active(
        db: Database, model_type: str
    ) -> Optional[Dict[str, Any]]:
        return _decode_json_fields(
            db.query_one(
                "SELECT * FROM model_versions WHERE model_type = ?"
                " AND is_active = 1 LIMIT 1",
                (model_type,),
            ),
            "config", "performance_metrics",
        )

    @staticmethod
    def set_active(db: Database, mv_id: int) -> Optional[Dict[str, Any]]:
        mv = ModelVersionCRUD.get(db, mv_id)
        if not mv:
            return None
        db.execute(
            "UPDATE model_versions SET is_active = 0 WHERE model_type = ?",
            (mv["model_type"],),
        )
        db.update(
            "model_versions", mv_id, {"is_active": True, "updated_at": _now()}
        )
        return ModelVersionCRUD.get(db, mv_id)

    @staticmethod
    def update(
        db: Database, mv_id: int, update: schemas.ModelVersionUpdate
    ) -> Optional[Dict[str, Any]]:
        data = update.model_dump(exclude_unset=True)
        if data:
            data["updated_at"] = _now()
            db.update("model_versions", mv_id, data)
        return ModelVersionCRUD.get(db, mv_id)
