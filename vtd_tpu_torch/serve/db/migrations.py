"""Schema migrations (PRAGMA user_version based).

The reference shipped only an ``alembic.ini`` stub with zero migration
files (SURVEY.md §2.2 "Engine/session": no Alembic migrations exist).
This module provides the working equivalent for the sqlite backend: an
ordered list of idempotent migration steps, each bumping
``PRAGMA user_version``; ``init_db`` applies the base schema and then
any pending migrations, so live databases upgrade in place.
"""
from __future__ import annotations

import logging
from typing import List, Tuple

logger = logging.getLogger(__name__)

# (version, description, sql or callable(db))
MIGRATIONS: List[Tuple[int, str, object]] = [
    (
        1,
        "baseline schema",
        None,  # created by Database.init_db's SCHEMA script
    ),
    (
        2,
        "index detections by creation time for export scans",
        "CREATE INDEX IF NOT EXISTS idx_dets_created"
        " ON text_detections(created_at)",
    ),
    (
        3,
        "index jobs by status for active-job guards",
        "CREATE INDEX IF NOT EXISTS idx_jobs_status"
        " ON processing_jobs(status)",
    ),
]


def current_version(db) -> int:
    return db.get_schema_version()


def migrate(db) -> int:
    """Apply pending migrations; returns the resulting schema version.

    ``db`` is any backend exposing the Database surface plus
    ``get_schema_version``/``set_schema_version`` (sqlite stores it in
    ``PRAGMA user_version``, Postgres in a ``schema_version`` table) —
    the step SQL itself is dialect-portable.
    """
    version = current_version(db)
    for target, desc, action in MIGRATIONS:
        if target <= version:
            continue
        if callable(action):
            action(db)
        elif isinstance(action, str):
            db.execute(action)
        db.set_schema_version(target)
        logger.info("migrated schema to v%d: %s", target, desc)
        version = target
    return version
