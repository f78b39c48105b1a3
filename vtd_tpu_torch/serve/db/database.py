"""Database engine/session layer (sqlite3 default, Postgres by DSN).

Replaces the reference's SQLAlchemy engine + session factory
(reference ``app/database/database.py``); port of
``vtd_tpu/serve/db/database.py``. A thread-safe sqlite3 wrapper
provides the same surface without SQLAlchemy:
``get_db`` dependency, ``init_db``, ``check_db_connection``, and a
``db_manager.health_check`` returning the same status dict shape.

DSN selects the backend, mirroring the reference's prod/test split
(sqlite for tests, Postgres in prod, ``database.py:10-17``):
``sqlite:///path.db`` / ``sqlite:///:memory:`` (shared in-memory
database per Database instance, so all server threads see one store);
``postgresql://user:pw@host/db`` routes to :class:`PostgresDatabase`,
import-gated on ``psycopg2`` exactly like StorageService gates S3 on
boto3 — absent driver raises a clear error instead of silently
degrading.
"""
from __future__ import annotations

import json
import logging
import sqlite3
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

logger = logging.getLogger(__name__)

SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    email TEXT UNIQUE NOT NULL,
    username TEXT UNIQUE NOT NULL,
    hashed_password TEXT NOT NULL,
    is_active INTEGER DEFAULT 1,
    is_superuser INTEGER DEFAULT 0,
    created_at TEXT DEFAULT (strftime('%Y-%m-%dT%H:%M:%f', 'now')),
    updated_at TEXT
);
CREATE TABLE IF NOT EXISTS videos (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    filename TEXT NOT NULL,
    original_filename TEXT NOT NULL,
    file_path TEXT NOT NULL,
    file_size INTEGER NOT NULL,
    duration REAL,
    fps REAL,
    width INTEGER,
    height INTEGER,
    category TEXT,
    owner_id INTEGER NOT NULL REFERENCES users(id),
    created_at TEXT DEFAULT (strftime('%Y-%m-%dT%H:%M:%f', 'now')),
    updated_at TEXT
);
CREATE TABLE IF NOT EXISTS frames (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    video_id INTEGER NOT NULL REFERENCES videos(id) ON DELETE CASCADE,
    frame_number INTEGER NOT NULL,
    timestamp REAL NOT NULL,
    file_path TEXT NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    created_at TEXT DEFAULT (strftime('%Y-%m-%dT%H:%M:%f', 'now'))
);
CREATE TABLE IF NOT EXISTS text_detections (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    frame_id INTEGER NOT NULL REFERENCES frames(id) ON DELETE CASCADE,
    text_content TEXT NOT NULL,
    confidence REAL NOT NULL,
    bbox_x1 INTEGER NOT NULL,
    bbox_y1 INTEGER NOT NULL,
    bbox_x2 INTEGER NOT NULL,
    bbox_y2 INTEGER NOT NULL,
    language TEXT,
    category TEXT,
    model_name TEXT NOT NULL,
    model_version TEXT NOT NULL,
    created_at TEXT DEFAULT (strftime('%Y-%m-%dT%H:%M:%f', 'now'))
);
CREATE TABLE IF NOT EXISTS processing_jobs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    celery_task_id TEXT UNIQUE NOT NULL,
    video_id INTEGER NOT NULL REFERENCES videos(id),
    status TEXT DEFAULT 'pending',
    progress REAL DEFAULT 0.0,
    total_frames INTEGER,
    processed_frames INTEGER DEFAULT 0,
    result_data TEXT,
    error_message TEXT,
    started_at TEXT,
    completed_at TEXT,
    created_at TEXT DEFAULT (strftime('%Y-%m-%dT%H:%M:%f', 'now'))
);
CREATE TABLE IF NOT EXISTS model_versions (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    version TEXT NOT NULL,
    model_type TEXT NOT NULL,
    file_path TEXT NOT NULL,
    config TEXT,
    is_active INTEGER DEFAULT 0,
    performance_metrics TEXT,
    created_at TEXT DEFAULT (strftime('%Y-%m-%dT%H:%M:%f', 'now')),
    updated_at TEXT
);
CREATE INDEX IF NOT EXISTS idx_videos_owner ON videos(owner_id);
CREATE INDEX IF NOT EXISTS idx_frames_video ON frames(video_id);
CREATE INDEX IF NOT EXISTS idx_dets_frame ON text_detections(frame_id);
CREATE INDEX IF NOT EXISTS idx_jobs_video ON processing_jobs(video_id);
CREATE INDEX IF NOT EXISTS idx_jobs_task ON processing_jobs(celery_task_id);
"""


class Database:
    """Thread-safe sqlite3 handle with row dicts and JSON columns."""

    def __init__(self, url: Optional[str] = None):
        from ...core.config import settings

        url = url or settings.database_url
        if url.startswith("sqlite:///"):
            path = url[len("sqlite:///"):]
        elif url.startswith("sqlite://"):
            path = url[len("sqlite://"):] or ":memory:"
        else:
            logger.warning("Unsupported sqlite DSN %s; using ./vtd.db", url)
            path = "./vtd.db"
        if path in (":memory:", ""):
            # One in-memory DB shared across this instance's threads but
            # private to the instance (unique shared-cache name).
            import uuid as _uuid

            path = f"file:memdb_{_uuid.uuid4().hex}?mode=memory&cache=shared"
            self._conn = sqlite3.connect(
                path, uri=True, check_same_thread=False
            )
        else:
            self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA foreign_keys = ON")
        self._lock = threading.RLock()
        self.path = path

    # -- core ops --------------------------------------------------------
    def execute(self, sql: str, params=()) -> sqlite3.Cursor:
        with self._lock:
            cur = self._conn.execute(sql, params)
            self._conn.commit()
            return cur

    def executemany(self, sql: str, seq) -> sqlite3.Cursor:
        with self._lock:
            cur = self._conn.executemany(sql, seq)
            self._conn.commit()
            return cur

    def query_one(self, sql: str, params=()) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._conn.execute(sql, params).fetchone()
        return dict(row) if row else None

    def query_all(self, sql: str, params=()) -> list:
        with self._lock:
            rows = self._conn.execute(sql, params).fetchall()
        return [dict(r) for r in rows]

    def insert(self, table: str, data: Dict[str, Any]) -> int:
        keys = list(data)
        sql = (
            f"INSERT INTO {table} ({', '.join(keys)}) "
            f"VALUES ({', '.join('?' for _ in keys)})"
        )
        cur = self.execute(sql, [_encode(v) for v in data.values()])
        return int(cur.lastrowid)

    def update(self, table: str, row_id: int, data: Dict[str, Any]) -> None:
        if not data:
            return
        sets = ", ".join(f"{k} = ?" for k in data)
        self.execute(
            f"UPDATE {table} SET {sets} WHERE id = ?",
            [_encode(v) for v in data.values()] + [row_id],
        )

    # -- lifecycle ---------------------------------------------------------
    def init_db(self) -> None:
        with self._lock:
            self._conn.executescript(SCHEMA)
            self._conn.commit()
        from .migrations import migrate

        migrate(self)

    def get_schema_version(self) -> int:
        row = self.query_one("PRAGMA user_version")
        return int(row["user_version"]) if row else 0

    def set_schema_version(self, version: int) -> None:
        self.execute(f"PRAGMA user_version = {int(version)}")

    def health_check(self) -> Dict[str, Any]:
        """Same status dict shape as db_manager.health_check
        (reference database.py:68-82)."""
        try:
            t0 = time.time()
            self.query_one("SELECT 1 as ok")
            return {
                "status": "healthy",
                "response_time_ms": round((time.time() - t0) * 1000, 2),
                "database": self.path,
            }
        except Exception as e:
            return {"status": "unhealthy", "error": str(e)}

    def close(self):
        with self._lock:
            self._conn.close()


def _encode(v: Any) -> Any:
    if isinstance(v, (dict, list)):
        return json.dumps(v, default=str)
    if isinstance(v, bool):
        return int(v)
    if hasattr(v, "value") and not isinstance(v, (int, float, str)):
        return v.value  # enums
    return v


# ---------------------------------------------------------------------------
# Postgres backend (DSN-selected; the reference runs Postgres in prod,
# app/database/database.py:10-17). The psycopg2 import is gated at
# construction time.
# ---------------------------------------------------------------------------
def pg_schema() -> str:
    """The sqlite SCHEMA translated to the Postgres dialect — one
    source of truth, two dialects."""
    import re

    s = SCHEMA.replace(
        "INTEGER PRIMARY KEY AUTOINCREMENT", "BIGSERIAL PRIMARY KEY"
    )
    s = re.sub(
        re.escape("(strftime('%Y-%m-%dT%H:%M:%f', 'now'))"),
        "(to_char(now() at time zone 'utc', 'YYYY-MM-DD\"T\"HH24:MI:SS.MS'))",
        s,
    )
    return s


def pg_sql(sql: str) -> str:
    """Rewrite sqlite-style ``?`` placeholders to psycopg2 ``%s``.

    Every query in serve/db uses ``?`` params with no literal question
    marks, so a plain substitution is exact.
    """
    return sql.replace("?", "%s")


class PostgresDatabase:
    """Postgres implementation of the :class:`Database` surface.

    Same public methods (execute/executemany/query_one/query_all/
    insert/update/init_db/health_check/close); CRUD and the migration
    runner work against either backend unchanged.
    """

    def __init__(self, url: str):
        try:
            import psycopg2
            import psycopg2.extras
        except ImportError as e:  # pragma: no cover - driver not installed
            raise RuntimeError(
                "database_url selects Postgres but psycopg2 is not "
                "installed; pip install psycopg2-binary or use a "
                "sqlite:/// DSN"
            ) from e
        self._psycopg2 = psycopg2
        self._dict_cursor = psycopg2.extras.RealDictCursor
        self._conn = psycopg2.connect(url)
        self._conn.autocommit = True
        self._lock = threading.RLock()
        self.path = url

    def execute(self, sql: str, params=()):
        with self._lock, self._conn.cursor() as cur:
            cur.execute(pg_sql(sql), tuple(params))
            return cur

    def executemany(self, sql: str, seq):
        with self._lock, self._conn.cursor() as cur:
            cur.executemany(pg_sql(sql), [tuple(p) for p in seq])
            return cur

    def query_one(self, sql: str, params=()) -> Optional[Dict[str, Any]]:
        with self._lock, self._conn.cursor(
            cursor_factory=self._dict_cursor
        ) as cur:
            cur.execute(pg_sql(sql), tuple(params))
            row = cur.fetchone()
        return dict(row) if row else None

    def query_all(self, sql: str, params=()) -> list:
        with self._lock, self._conn.cursor(
            cursor_factory=self._dict_cursor
        ) as cur:
            cur.execute(pg_sql(sql), tuple(params))
            rows = cur.fetchall()
        return [dict(r) for r in rows]

    def insert(self, table: str, data: Dict[str, Any]) -> int:
        keys = list(data)
        sql = (
            f"INSERT INTO {table} ({', '.join(keys)}) "
            f"VALUES ({', '.join('%s' for _ in keys)}) RETURNING id"
        )
        with self._lock, self._conn.cursor() as cur:
            cur.execute(sql, [_encode(v) for v in data.values()])
            return int(cur.fetchone()[0])

    def update(self, table: str, row_id: int, data: Dict[str, Any]) -> None:
        if not data:
            return
        sets = ", ".join(f"{k} = %s" for k in data)
        with self._lock, self._conn.cursor() as cur:
            cur.execute(
                f"UPDATE {table} SET {sets} WHERE id = %s",
                [_encode(v) for v in data.values()] + [row_id],
            )

    def init_db(self) -> None:
        with self._lock, self._conn.cursor() as cur:
            cur.execute(pg_schema())
            cur.execute(
                "CREATE TABLE IF NOT EXISTS schema_version "
                "(version BIGINT NOT NULL)"
            )
        from .migrations import migrate

        migrate(self)

    def get_schema_version(self) -> int:
        row = self.query_one("SELECT version FROM schema_version LIMIT 1")
        return int(row["version"]) if row else 0

    def set_schema_version(self, version: int) -> None:
        with self._lock, self._conn.cursor() as cur:
            cur.execute("DELETE FROM schema_version")
            cur.execute(
                "INSERT INTO schema_version (version) VALUES (%s)",
                (int(version),),
            )

    def health_check(self) -> Dict[str, Any]:
        try:
            t0 = time.time()
            self.query_one("SELECT 1 as ok")
            return {
                "status": "healthy",
                "response_time_ms": round((time.time() - t0) * 1000, 2),
                "database": self.path,
            }
        except Exception as e:
            return {"status": "unhealthy", "error": str(e)}

    def close(self):
        with self._lock:
            self._conn.close()


def make_database(url: Optional[str] = None):
    """DSN-dispatching factory: ``postgresql://``/``postgres://`` →
    :class:`PostgresDatabase`, anything else → sqlite
    :class:`Database`."""
    if url is None:
        from ...core.config import settings

        url = settings.database_url
    if url.startswith(("postgresql://", "postgres://")):
        return PostgresDatabase(url)
    return Database(url)


# ---------------------------------------------------------------------------
# Module-level default database (the reference's engine + SessionLocal)
# ---------------------------------------------------------------------------
_default_db: Optional[Database] = None
_default_lock = threading.Lock()


def get_database(url: Optional[str] = None) -> Database:
    global _default_db
    with _default_lock:
        if _default_db is None or url is not None:
            _default_db = make_database(url)
        return _default_db


def set_database(db: Database) -> None:
    """Dependency override hook (the reference overrides ``get_db`` in
    tests, tests/test_api.py:25-32)."""
    global _default_db
    with _default_lock:
        _default_db = db


@contextmanager
def get_db() -> Iterator[Database]:
    yield get_database()


def SessionLocal() -> Database:
    """Parity shim: reference code imports SessionLocal directly
    (app/tasks/video_processing.py:11)."""
    return get_database()


def init_db(url: Optional[str] = None) -> None:
    get_database(url).init_db()


def check_db_connection() -> bool:
    try:
        return get_database().health_check()["status"] == "healthy"
    except Exception:
        return False


class DatabaseManager:
    def health_check(self) -> Dict[str, Any]:
        return get_database().health_check()


db_manager = DatabaseManager()
