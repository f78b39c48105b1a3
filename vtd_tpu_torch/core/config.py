"""Application settings (port of ``vtd_tpu/core/config.py``).

The same setting names, defaults and environment variables as the
reference, read the way the reference's plain-object branch reads them
(``vtd_tpu/core/config.py:107-183``): a keyword wins, then the upper-case
environment variable coerced to the default's type, then the default.
The port never needs pydantic for it.

One setting is new: ``device`` (``DEVICE``), where the serving pipelines
run, ``"cuda"`` by default. ``serve`` and ``worker`` write their
``--device`` back into ``DEVICE``, since the process pool's children
read their settings from the environment. ``data_parallel_chips = N > 0``
serves every job over a mesh of the process's first N devices
(``serve/tasks.py:_build_pipeline``; N entries of the CPU where
``device`` is ``"cpu"``).
"""
from __future__ import annotations

import os
from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = dict(
    app_name="Video Text Detection API",
    debug=False,
    version="1.0.0",
    database_url="sqlite:///./vtd.db",
    redis_url="redis://localhost:6379/0",
    secret_key="change-me-in-production",
    algorithm="HS256",
    access_token_expire_minutes=30,
    aws_access_key_id=None,
    aws_secret_access_key=None,
    aws_region="us-east-1",
    s3_bucket_name=None,
    max_file_size=500 * 1024 * 1024,
    max_video_duration=300,
    supported_formats=["mp4", "avi", "mov", "mkv"],
    model_path="./models",
    temp_dir="./temp",
    output_dir="./output",
    celery_broker_url="local://",
    celery_result_backend="local://",
    worker_pool="thread",
    rate_limit_store_url="memory://",
    log_level="INFO",
    enable_metrics=True,
    metrics_port=9090,
    gpu_enabled=True,
    batch_size=32,
    confidence_threshold=0.5,
    detector_input_size=640,
    max_detections_per_frame=64,
    recognizer_height=32,
    recognizer_width=128,
    frame_batch_size=8,
    target_sample_fps=10.0,
    compute_dtype="bfloat16",
    mesh_data_axis="data",
    mesh_model_axis="model",
    data_parallel_chips=0,
    profile_trace_dir="",
    device="cuda",
)


class Settings:
    def __init__(self, **kw):
        for k, v in _DEFAULTS.items():
            if k in kw:
                setattr(self, k, kw[k])
                continue
            env = os.environ.get(k.upper())
            setattr(self, k, v if env is None else _coerce(env, v))


def _coerce(raw: str, default):
    """Coerce an environment string to the default's type: without it
    MAX_FILE_SIZE=... lands as a string and every size comparison fails,
    and DEBUG=false turns debug on."""
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        try:
            return int(raw)
        except ValueError:
            return default
    if isinstance(default, float):
        try:
            return float(raw)
        except ValueError:
            return default
    if isinstance(default, list):
        return [p.strip() for p in raw.split(",") if p.strip()]
    return raw


settings = Settings()
