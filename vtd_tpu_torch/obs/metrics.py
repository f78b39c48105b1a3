"""Prometheus metrics (port of ``vtd_tpu/obs/metrics.py``).

The same series names, labels and default histogram buckets as the
reference, kept in the port's own :class:`Registry` and rendered in the
Prometheus text exposition format 0.0.4 by :func:`generate_latest`, and
served on a port of its own by :func:`start_metrics_server`. The
port does not use ``prometheus_client``: its global registry hands an
existing collector back by name (``vtd_tpu/obs/metrics.py:29-35``), so
in a process that imports both packages the port's counters would be the
reference's. The ``*_created`` samples that ``prometheus_client`` adds
are not rendered.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

try:
    import psutil

    _HAVE_PSUTIL = True
except ImportError:  # pragma: no cover
    _HAVE_PSUTIL = False

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
    7.5, 10.0, math.inf,
)


def _fmt(v: float) -> str:
    """A sample value as Go's strconv prints it (prometheus_client's
    ``floatToGoString``)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    s = repr(float(v))
    mantissa, _, exp = s.partition("e")
    if exp:
        sign = exp[0] if exp[0] in "+-" else "+"
        digits = exp.lstrip("+-").lstrip("0") or "0"
        return f"{mantissa}e{sign}{digits.zfill(2)}"
    return s


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labels(names: Sequence[str], values: Sequence[str], extra=()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(str(v))}"' for k, v in pairs) + "}"


class Registry:
    """Collectors by name; ``render`` writes the exposition text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._collectors: Dict[str, "_Metric"] = {}

    def register(self, metric: "_Metric") -> None:
        with self._lock:
            if metric.name in self._collectors:
                raise ValueError(f"duplicate metric {metric.name!r}")
            self._collectors[metric.name] = metric

    def render(self) -> str:
        with self._lock:
            metrics = list(self._collectors.values())
        return "".join(m.render() for m in metrics)


REGISTRY = Registry()


class _Metric:
    type_name = ""

    def __init__(
        self, name: str, documentation: str,
        labelnames: Sequence[str] = (), registry: Optional[Registry] = REGISTRY,
    ):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        self._labelvalues: Tuple[str, ...] = ()
        self._init_value()
        if registry is not None:
            registry.register(self)

    def _init_value(self) -> None:
        pass

    def labels(self, *values, **kw) -> "_Metric":
        if kw:
            values = tuple(kw[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values}"
            )
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self).__new__(type(self))
                child.name = self.name
                child.labelnames = self.labelnames
                child._lock = threading.Lock()
                child._labelvalues = key
                child._init_value()
                self._children[key] = child
        return child

    def _series(self) -> List["_Metric"]:
        if self.labelnames:
            with self._lock:
                return list(self._children.values())
        return [self]

    def _samples(self) -> List[Tuple[str, str, float]]:
        raise NotImplementedError

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.documentation}",
            f"# TYPE {self.name} {self.type_name}",
        ]
        for series in self._series():
            for suffix, labels, value in series._samples():
                lines.append(f"{self.name}{suffix}{labels} {_fmt(value)}")
        return "\n".join(lines) + "\n"


class Counter(_Metric):
    type_name = "counter"

    def _init_value(self):
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    def _samples(self):
        return [("", _labels(self.labelnames, self._labelvalues), self._value)]


class Gauge(_Metric):
    type_name = "gauge"

    def _init_value(self):
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def _samples(self):
        return [("", _labels(self.labelnames, self._labelvalues), self._value)]


class Histogram(_Metric):
    """Counts per bucket of ``DEFAULT_BUCKETS`` (the reference's)."""

    type_name = "histogram"

    def _init_value(self):
        self._counts = [0.0] * len(DEFAULT_BUCKETS)
        self._sum = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            for i, bound in enumerate(DEFAULT_BUCKETS):
                if value <= bound:
                    self._counts[i] += 1
                    break

    def _samples(self):
        out = []
        acc = 0.0
        for bound, n in zip(DEFAULT_BUCKETS, self._counts):
            acc += n
            out.append((
                "_bucket",
                _labels(self.labelnames, self._labelvalues,
                        [("le", _fmt(bound))]),
                acc,
            ))
        base = _labels(self.labelnames, self._labelvalues)
        out.append(("_count", base, acc))
        out.append(("_sum", base, self._sum))
        return out


class Info(_Metric):
    """A constant-1 gauge whose labels carry the information, rendered
    as ``<name>_info`` (so ``app_info`` is ``app_info_info``, as
    prometheus_client names it)."""

    type_name = "gauge"

    def __init__(self, name, documentation, labelnames=(), registry=REGISTRY):
        super().__init__(name + "_info", documentation, labelnames, registry)

    def _init_value(self):
        self._info: Dict[str, str] = {}

    def info(self, value: Dict[str, str]) -> None:
        with self._lock:
            self._info = {str(k): str(v) for k, v in value.items()}

    def _samples(self):
        if not self._info:
            return []
        return [("", _labels(tuple(self._info), tuple(self._info.values())),
                 1.0)]


def generate_latest(registry: Registry = REGISTRY) -> bytes:
    return registry.render().encode()


video_uploads_total = Counter(
    "video_uploads_total", "Total video uploads",
    labelnames=["category", "status"],
)
video_processing_duration = Histogram(
    "video_processing_duration_seconds", "Video processing duration"
)
active_processing_jobs = Gauge(
    "active_processing_jobs", "Number of active processing jobs"
)
text_detections_total = Counter(
    "text_detections_total", "Total text detections",
    labelnames=["model_type"],
)
system_cpu_usage = Gauge(
    "system_cpu_usage_percent", "System CPU usage percentage"
)
system_memory_usage = Gauge(
    "system_memory_usage_bytes", "System memory usage in bytes"
)
system_memory_total = Gauge(
    "system_memory_total_bytes", "Total system memory in bytes"
)
disk_usage = Gauge("disk_usage_bytes", "Disk usage in bytes",
                   labelnames=["path"])
disk_total = Gauge("disk_total_bytes", "Total disk space in bytes",
                   labelnames=["path"])
database_connections = Gauge(
    "database_connections_active", "Active database connections"
)
database_query_duration = Histogram(
    "database_query_duration_seconds", "Database query duration"
)
model_inference_duration = Histogram(
    "model_inference_duration_seconds", "Model inference duration",
    labelnames=["model_type"],
)
model_batch_size = Histogram(
    "model_batch_size", "Model batch size", labelnames=["model_type"],
)
celery_tasks_total = Counter(
    "celery_tasks_total", "Total worker tasks",
    labelnames=["task_name", "status"],
)
celery_task_duration = Histogram(
    "celery_task_duration_seconds", "Worker task duration",
    labelnames=["task_name"],
)
app_info = Info("app_info", "Application information")

# device-side series of the reference
tpu_step_duration = Histogram(
    "tpu_step_duration_seconds",
    "Fused device step (preprocess+detect+postprocess+crop) duration",
    labelnames=["stage"],
)
recognizer_chunk_occupancy = Histogram(
    "recognizer_chunk_occupancy",
    "Fraction of recognizer chunk slots holding real crops",
)

# HTTP series of the middleware (vtd_tpu/serve/middleware.py:26-36)
http_requests_total = Counter(
    "http_requests_total", "Total HTTP requests",
    labelnames=["method", "endpoint", "status"],
)
http_request_duration = Histogram(
    "http_request_duration_seconds", "HTTP request duration",
    labelnames=["method", "endpoint"],
)
http_requests_active = Gauge("http_requests_active", "Active HTTP requests")


class MetricsCollector:
    """record_* helpers + a 60 s-throttled system sampler."""

    def __init__(self):
        self.last_system_update = 0.0
        self.update_interval = 60.0

    def update_system_metrics(self) -> None:
        now = time.time()
        if now - self.last_system_update < self.update_interval:
            return
        if not _HAVE_PSUTIL:
            return
        try:
            system_cpu_usage.set(psutil.cpu_percent(interval=None))
            mem = psutil.virtual_memory()
            system_memory_usage.set(mem.used)
            system_memory_total.set(mem.total)
            disk = psutil.disk_usage("/")
            disk_usage.labels(path="/").set(disk.used)
            disk_total.labels(path="/").set(disk.total)
            self.last_system_update = now
        except Exception as e:
            logger.warning("system metrics update failed: %s", e)

    def record_video_upload(self, category: str = "other", status: str = "success"):
        video_uploads_total.labels(category or "other", status).inc()

    def record_processing_duration(self, seconds: float):
        video_processing_duration.observe(seconds)

    def record_text_detections(self, count: int, model_type: str = "DBNet-CRNN"):
        text_detections_total.labels(model_type).inc(count)

    def record_model_inference(self, seconds: float, model_type: str, batch: int):
        model_inference_duration.labels(model_type).observe(seconds)
        model_batch_size.labels(model_type).observe(batch)

    def record_task(self, task_name: str, status: str, duration: float):
        celery_tasks_total.labels(task_name, status).inc()
        celery_task_duration.labels(task_name).observe(duration)

    def set_active_jobs(self, n: int):
        active_processing_jobs.set(n)

    def set_database_status(self, connected: bool):
        database_connections.set(1 if connected else 0)

    def set_app_info(self, info: Dict[str, str]):
        app_info.info(info)


metrics_collector = MetricsCollector()


CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server's name
        body = generate_latest(REGISTRY)
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE_LATEST)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # no access log on stderr
        pass


def start_metrics_server(
    port: int = 9091, addr: str = "0.0.0.0"
) -> Optional[ThreadingHTTPServer]:
    """Serve the port's registry in format 0.0.4 on every GET path of
    ``addr:port`` from a daemon thread: the worker side's standalone
    metrics server. A port that cannot be bound (taken, say) logs a
    warning and returns None, as the reference does; otherwise returns
    the server (``shutdown()`` stops it)."""
    try:
        server = ThreadingHTTPServer((addr, port), _MetricsHandler)
    except OSError as e:
        logger.warning("metrics server not started: %s", e)
        return None
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="metrics-server").start()
    logger.info("Metrics server on :%d", server.server_address[1])
    return server
