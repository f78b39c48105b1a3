"""Structured JSON logging (port of ``vtd_tpu/obs/logging.py``).

A stdlib ``logging.Formatter`` writing one-line JSON records (timestamp,
level, logger, event, exception) with ``extra={...}`` fields.
"""
from __future__ import annotations

import json
import logging
import sys
import time
import traceback
from typing import Any, Dict, Optional

_RESERVED = set(
    logging.LogRecord(
        "", 0, "", 0, "", (), None
    ).__dict__
) | {"message", "asctime"}


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "timestamp": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname.lower(),
            "logger": record.name,
            "event": record.getMessage(),
        }
        for k, v in record.__dict__.items():
            if k not in _RESERVED and not k.startswith("_"):
                try:
                    json.dumps(v)
                    out[k] = v
                except (TypeError, ValueError):
                    out[k] = repr(v)
        if record.exc_info:
            out["exception"] = "".join(
                traceback.format_exception(*record.exc_info)
            )
        return json.dumps(out)


def configure_logging(
    level: Optional[str] = None, json_format: bool = True
) -> None:
    """Configure root logging (JSON by default, like the reference API)."""
    from ..core.config import settings

    level = level or settings.log_level
    handler = logging.StreamHandler(sys.stdout)
    if json_format:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s %(message)s"
            )
        )
    root = logging.getLogger()
    root.handlers = [handler]
    root.setLevel(getattr(logging, str(level).upper(), logging.INFO))
