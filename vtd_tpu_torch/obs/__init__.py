"""Observability (port of ``vtd_tpu/obs``): JSON logging, the port's own
Prometheus registry, and health checks with a CUDA probe."""

from .metrics import MetricsCollector, metrics_collector
from .health import HealthCheck, HealthMonitor, health_monitor

__all__ = [
    "MetricsCollector",
    "metrics_collector",
    "HealthCheck",
    "HealthMonitor",
    "health_monitor",
]
