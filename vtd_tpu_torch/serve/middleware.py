"""HTTP middleware stack (port of ``vtd_tpu/serve/middleware.py``).

Behavior parity with reference ``app/api/middleware.py``: request
logging + Prometheus counters + X-Process-Time header, fixed-window
rate limiting per (ip, path-prefix) with the same limits (/auth 10/min,
/processing 5/min, default 100/min) that *fails open* on limiter errors,
permissive CORS, security headers, and a last-resort error wrapper.

The counters live in the port's own registry (``obs/metrics.py``). The
rate-limit store is in-memory by default, or a shared sqlite file.
"""
from __future__ import annotations

import logging
import re
import threading
import time
from typing import Dict, Tuple

from ..obs.metrics import (
    http_request_duration as REQUEST_DURATION,
    http_requests_active as ACTIVE_REQUESTS,
    http_requests_total as REQUEST_COUNT,
)
from .http import HTTPException, Request, Response

logger = logging.getLogger("vtd.access")


class InMemoryWindowStore:
    """Fixed-window counter store (Redis INCR/EXPIRE equivalent)."""

    def __init__(self):
        self._data: Dict[str, Tuple[int, float]] = {}
        self._lock = threading.Lock()

    def incr_window(self, key: str, window_s: float) -> int:
        now = time.time()
        with self._lock:
            count, start = self._data.get(key, (0, now))
            if now - start >= window_s:
                count, start = 0, now
            count += 1
            self._data[key] = (count, start)
            # opportunistic GC, amortized: when >10k keys are LIVE the
            # size check alone would rebuild the dict on EVERY request
            # (O(n) under the lock, exactly under flood load) — sweep at
            # most once per 4096 increments instead.
            self._ops = getattr(self, "_ops", 0) + 1
            if len(self._data) > 10000 and self._ops % 4096 == 0:
                self._data = {
                    k: v
                    for k, v in self._data.items()
                    if now - v[1] < window_s
                }
            return count


class SqliteWindowStore:
    """Fixed-window counter store shared across worker processes and
    replicas through one sqlite file (WAL mode), so N replicas enforce
    the configured limit rather than N× it. The reference shared this
    state via Redis (app/api/middleware.py:69-116); a sqlite file on a
    shared volume needs no extra service. Callers fail open on errors,
    matching the reference's Redis-down behavior.
    """

    # Expired rows are swept opportunistically every N increments
    # (mirrors InMemoryWindowStore's GC) so distinct (ip, path) keys
    # don't grow the table unboundedly on a long-lived shared store.
    _GC_EVERY = 256

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        self._ops = 0
        self._max_window = 60.0  # largest window this store has served
        # create schema eagerly so incr_window never races CREATE
        con = self._conn()
        con.execute(
            "CREATE TABLE IF NOT EXISTS rate_windows ("
            "key TEXT PRIMARY KEY, count INTEGER, start REAL)"
        )
        con.commit()

    def _conn(self):
        con = getattr(self._local, "con", None)
        if con is None:
            import sqlite3

            # autocommit mode; transactions are managed explicitly so
            # BEGIN IMMEDIATE takes the write lock up front
            con = sqlite3.connect(
                self.path, timeout=5.0, isolation_level=None
            )
            con.execute("PRAGMA journal_mode=WAL")
            con.execute("PRAGMA synchronous=NORMAL")
            self._local.con = con
        return con

    def incr_window(self, key: str, window_s: float) -> int:
        now = time.time()
        con = self._conn()
        con.execute("BEGIN IMMEDIATE")
        try:
            row = con.execute(
                "SELECT count, start FROM rate_windows WHERE key=?", (key,)
            ).fetchone()
            if row is None or now - row[1] >= window_s:
                count, start = 1, now
            else:
                count, start = row[0] + 1, row[1]
            con.execute(
                "INSERT OR REPLACE INTO rate_windows VALUES (?,?,?)",
                (key, count, start),
            )
            self._ops += 1
            self._max_window = max(self._max_window, window_s, 60.0)
            if self._ops % self._GC_EVERY == 0:
                # GC against the largest window THIS store has served —
                # sweeping with the current call's window would delete
                # live counters of longer-window limit classes sharing
                # the table (e.g. an hourly quota next to per-minute
                # limits).
                con.execute(
                    "DELETE FROM rate_windows WHERE start < ?",
                    (now - 2 * self._max_window,),
                )
            con.execute("COMMIT")
        except BaseException:
            con.execute("ROLLBACK")
            raise
        return count


def make_window_store(url: str):
    """Build a window store from a settings URL: ``memory://`` (default,
    per-process) or ``sqlite:///path/to/file.db`` (shared across
    replicas)."""
    if url.startswith("sqlite:///"):
        return SqliteWindowStore(url[len("sqlite:///"):])
    return InMemoryWindowStore()


_ID_SEGMENT = re.compile(r"/\d+(?=/|$)")


def _endpoint_label(path: str) -> str:
    """Route-template-shaped metric label: numeric path segments become
    ':id' so /jobs/1, /jobs/2, ... share one timeseries — labeling by
    raw path mints a permanent label set per job/video id (unbounded
    exporter cardinality on a long-lived server). The reference labels
    by endpoint the same way (middleware.py:33-38)."""
    return _ID_SEGMENT.sub("/:id", path)


def logging_middleware(request: Request, call_next) -> Response:
    """Parity: middleware.py:20-67."""
    start = time.time()
    ACTIVE_REQUESTS.inc()
    try:
        response = call_next(request)
    finally:
        ACTIVE_REQUESTS.dec()
    duration = time.time() - start
    endpoint = _endpoint_label(request.path)
    REQUEST_COUNT.labels(request.method, endpoint, response.status_code).inc()
    REQUEST_DURATION.labels(request.method, endpoint).observe(duration)
    response.headers["X-Process-Time"] = f"{duration:.6f}"
    logger.info(
        '%s %s %d %.1fms ip=%s',
        request.method, request.path, response.status_code,
        duration * 1000, request.client_ip,
    )
    return response


def make_rate_limit_middleware(store=None):
    """Parity: middleware.py:69-116 (limits at :81-89; fails open)."""
    store = store or InMemoryWindowStore()

    def rate_limit_middleware(request: Request, call_next) -> Response:
        try:
            path = request.path
            if path.startswith("/api/v1/auth"):
                limit, bucket = 10, "auth"
            elif path.startswith("/api/v1/processing") and not (
                request.method == "GET" and "/jobs/" in path
            ):
                # Read-only job polling is exempt from the strict
                # 5/min mutation budget: both this repo's frontend and
                # the reference's poll status every 2 s (30/min), which
                # would rate-limit their own progress bars (the
                # reference shares this bug; "match-or-beat" says beat
                # it). Detect/cancel keep the strict limit.
                limit, bucket = 5, "processing"
            else:
                limit, bucket = 100, "default"
            key = f"rl:{request.client_ip}:{bucket}"
            count = store.incr_window(key, 60.0)
            if count > limit:
                return Response(
                    429,
                    {"detail": "Rate limit exceeded. Try again later."},
                    headers={"Retry-After": "60"},
                )
        except HTTPException:
            raise
        except Exception as e:  # fail open (middleware.py:113-116)
            logger.warning("rate limiter error (failing open): %s", e)
        return call_next(request)

    rate_limit_middleware.store = store
    return rate_limit_middleware


def cors_middleware(request: Request, call_next) -> Response:
    """Parity: middleware.py:118-135 (permissive '*')."""
    if request.method == "OPTIONS":
        response = Response(200, {})
    else:
        response = call_next(request)
    response.headers.update(
        {
            "Access-Control-Allow-Origin": "*",
            "Access-Control-Allow-Methods": "GET, POST, PUT, DELETE, OPTIONS",
            "Access-Control-Allow-Headers": "*",
            "Access-Control-Max-Age": "86400",
        }
    )
    return response


def security_headers_middleware(request: Request, call_next) -> Response:
    """Parity: middleware.py:137-147."""
    response = call_next(request)
    response.headers.update(
        {
            "X-Content-Type-Options": "nosniff",
            "X-Frame-Options": "DENY",
            "X-XSS-Protection": "1; mode=block",
            "Strict-Transport-Security": "max-age=31536000; includeSubDomains",
        }
    )
    # Handlers may set a stricter per-response CSP (the /app SPA uses a
    # per-request nonce); only apply the blanket default when absent.
    response.headers.setdefault(
        "Content-Security-Policy", "default-src 'self'"
    )
    return response


def error_handling_middleware(request: Request, call_next) -> Response:
    """Parity: middleware.py:149-170."""
    try:
        return call_next(request)
    except HTTPException:
        raise
    except Exception as e:
        logger.exception("middleware caught unhandled error")
        return Response(
            500,
            {
                "detail": "Internal server error",
                "error": str(e),
                "path": request.path,
            },
        )
