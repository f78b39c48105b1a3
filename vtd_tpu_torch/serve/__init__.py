"""Serving layer (port of ``vtd_tpu/serve``): REST API, job queue (thread
worker, process pool, file and TCP brokers), storage and DB, on the
Python stdlib (http.server, sqlite3, hmac/hashlib JWT, threads,
multiprocessing, sockets). Job pipelines run on the card."""

from .app import create_app

__all__ = ["create_app"]
