"""Storage service: local filesystem or S3-compatible object store.

Parity with reference ``app/services/storage_service.py``: date-bucketed
paths (``uploads/YYYY/MM/DD/`` locally, ``videos/YYYY/MM/DD/`` S3 keys),
store/retrieve/delete, MD5 checksums, and age-based temp-file GC.
Port of ``vtd_tpu/serve/services/storage_service.py``. The S3 backend
is gated on boto3: selecting it without boto3 raises at construction.
"""
from __future__ import annotations

import hashlib
import logging
import os
import shutil
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Optional

from ...core.config import settings

logger = logging.getLogger(__name__)

try:  # pragma: no cover
    import boto3

    _HAVE_BOTO = True
except ImportError:
    _HAVE_BOTO = False


class StorageService:
    def __init__(
        self, base_dir: Optional[str] = None, s3_client: Optional[Any] = None
    ):
        """``s3_client`` injects a ready client (the boto3 S3 client
        surface: upload_file/download_file/delete_object/head_object) —
        tests use a dict-backed stub; production passes None and the
        client is built from settings when an S3 bucket is configured."""
        self.use_s3 = bool(settings.s3_bucket_name)
        self.base_dir = Path(base_dir or "./uploads")
        if s3_client is not None:
            self.s3 = s3_client
        elif self.use_s3:
            if not _HAVE_BOTO:
                raise RuntimeError(
                    "S3 storage selected but boto3 is not installed"
                )
            self.s3 = boto3.client(
                "s3",
                aws_access_key_id=settings.aws_access_key_id,
                aws_secret_access_key=settings.aws_secret_access_key,
                region_name=settings.aws_region,
            )

    def _date_prefix(self) -> str:
        now = datetime.now(timezone.utc)
        return f"{now.year:04d}/{now.month:02d}/{now.day:02d}"

    # ------------------------------------------------------------------
    async def store_video(self, source_path: str, filename: str) -> str:
        """Returns the stored path (local path or s3:// URI)."""
        if self.use_s3:
            key = f"videos/{self._date_prefix()}/{filename}"
            self.s3.upload_file(source_path, settings.s3_bucket_name, key)
            return f"s3://{settings.s3_bucket_name}/{key}"
        dest_dir = self.base_dir / self._date_prefix()
        dest_dir.mkdir(parents=True, exist_ok=True)
        dest = dest_dir / filename
        shutil.copy2(source_path, dest)
        return str(dest)

    async def retrieve_video(self, stored_path: str, dest_path: str) -> str:
        if stored_path.startswith("s3://"):
            _, _, rest = stored_path.partition("s3://")
            bucket, _, key = rest.partition("/")
            self.s3.download_file(bucket, key, dest_path)
            return dest_path
        shutil.copy2(stored_path, dest_path)
        return dest_path

    async def delete_video(self, stored_path: str) -> bool:
        try:
            if stored_path.startswith("s3://"):
                _, _, rest = stored_path.partition("s3://")
                bucket, _, key = rest.partition("/")
                self.s3.delete_object(Bucket=bucket, Key=key)
                return True
            if os.path.exists(stored_path):
                os.remove(stored_path)
            return True
        except Exception as e:
            logger.error("Failed to delete %s: %s", stored_path, e)
            return False

    def exists(self, stored_path: str) -> bool:
        if stored_path.startswith("s3://"):
            _, _, rest = stored_path.partition("s3://")
            bucket, _, key = rest.partition("/")
            try:
                self.s3.head_object(Bucket=bucket, Key=key)
                return True
            except Exception:
                return False
        return os.path.exists(stored_path)

    # ------------------------------------------------------------------
    @staticmethod
    def calculate_checksum(file_path: str) -> str:
        """MD5 checksum (storage_service.py:144-153)."""
        md5 = hashlib.md5()
        with open(file_path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                md5.update(chunk)
        return md5.hexdigest()

    @staticmethod
    def cleanup_temp_files(
        temp_dir: Optional[str] = None, max_age_hours: float = 24.0
    ) -> int:
        """Delete temp files older than max_age (storage_service.py:155-180)."""
        temp_dir = temp_dir or settings.temp_dir
        if not os.path.isdir(temp_dir):
            return 0
        cutoff = time.time() - max_age_hours * 3600
        removed = 0
        for name in os.listdir(temp_dir):
            path = os.path.join(temp_dir, name)
            try:
                if os.path.isfile(path) and os.path.getmtime(path) < cutoff:
                    os.remove(path)
                    removed += 1
            except OSError as e:
                logger.warning("temp cleanup failed for %s: %s", path, e)
        return removed
