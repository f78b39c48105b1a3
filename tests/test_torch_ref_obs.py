"""The reference's ``tests/test_obs.py``, run against ``vtd_tpu_torch``.

Two cases meet recorded divergences and are replaced by port cases of
the same name:
- ``test_metrics_collector_records`` reads ``prometheus_client``'s global
  registry; the port's metrics live in its own registry, rendered by
  ``vtd_tpu_torch.obs.metrics.generate_latest``.
- ``test_health_checks_run_all`` expects the JAX backend's 8 virtual CPU
  devices; the port's accelerator check is the CUDA probe, unhealthy
  where CUDA is absent.
"""
import asyncio

import torch
from torch_ref_cases import cases, load

globals().update(cases(load("test_obs")))


def test_metrics_collector_records():
    from vtd_tpu_torch.obs.metrics import generate_latest, metrics_collector

    before = generate_latest().decode()
    metrics_collector.record_video_upload("sports", "success")
    metrics_collector.record_text_detections(5)
    metrics_collector.record_model_inference(0.01, "DBNet", 8)
    metrics_collector.record_task("process_video_task", "SUCCESS", 1.5)
    metrics_collector.set_active_jobs(2)
    metrics_collector.update_system_metrics()

    text = generate_latest().decode()
    for series in (
        "video_uploads_total",
        "text_detections_total",
        "model_inference_duration_seconds",
        "celery_tasks_total",
        "active_processing_jobs",
    ):
        assert series in text
    assert "active_processing_jobs 2.0" in text
    assert text != before


def test_health_checks_run_all():
    from vtd_tpu_torch.obs.health import HealthCheck

    checks = asyncio.run(HealthCheck().run_all())
    assert set(checks) >= {
        "database", "queue", "disk", "memory", "models", "accelerator",
        "external_apis",
    }
    assert all("status" in c for c in checks.values()), checks
    assert checks["database"]["status"] == "healthy"
    assert checks["queue"]["status"] == "healthy"
    acc = checks["accelerator"]
    if torch.cuda.is_available():
        assert acc["status"] == "healthy", acc
        assert acc["count"] == torch.cuda.device_count()
    else:
        assert acc["status"] == "unhealthy", acc
        assert "CUDA" in acc["error"] and "count" not in acc
