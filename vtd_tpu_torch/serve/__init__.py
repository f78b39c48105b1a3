"""Serving layer (port of ``vtd_tpu/serve``): REST API, thread-worker
job queue, storage and DB, on the Python stdlib (http.server, sqlite3,
hmac/hashlib JWT, threads). Job pipelines run on the card."""

from .app import create_app

__all__ = ["create_app"]
