"""Health checks (port of ``vtd_tpu/obs/health.py``): check-set parity with reference
``app/monitoring/health.py``: database, queue broker, disk, memory,
worker, model files, external storage; a caching ``HealthMonitor`` with
k8s-style readiness (critical = db/queue/disk/memory) and liveness
(memory/disk) derivations (health.py:288-329).

The reference's redis/celery probes become a probe of the configured
broker: the queue directory of ``file://``, a ``ping`` of ``brokerd``
for ``tcp://``, the in-process worker pool's stats for ``local://``.

The accelerator check is the port's CUDA probe: CUDA present, a tiny op
on each card's default device, ``torch.cuda.synchronize()``, all in a
helper thread under a 10 s deadline. Without CUDA it reports unhealthy;
it never reports the CPU as the accelerator.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..core.config import settings

logger = logging.getLogger(__name__)

try:
    import psutil

    _HAVE_PSUTIL = True
except ImportError:  # pragma: no cover
    _HAVE_PSUTIL = False


PROBE_TIMEOUT_S = 10.0


def cuda_probe() -> Dict[str, Any]:
    """``{"devices": [name, ...]}`` after one small op on every card has
    finished; raises RuntimeError when CUDA is absent."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    names = []
    for i in range(torch.cuda.device_count()):
        x = torch.ones(1, device=f"cuda:{i}")
        if float((x + 1).item()) != 2.0:
            raise RuntimeError(f"cuda:{i} returned a wrong sum")
        torch.cuda.synchronize(i)
        names.append(torch.cuda.get_device_name(i))
    return {"devices": names}


def _ok(**extra) -> Dict[str, Any]:
    return {"status": "healthy", **extra}


def _bad(error: str, **extra) -> Dict[str, Any]:
    return {"status": "unhealthy", "error": error, **extra}


class HealthCheck:
    """Individual async checks (reference health.py:16-267)."""

    async def check_database(self) -> Dict[str, Any]:
        from ..serve.db.database import get_database

        try:
            return get_database().health_check()
        except Exception as e:
            return _bad(str(e))

    async def check_queue(self) -> Dict[str, Any]:
        """Broker probe. ``file://`` -> the queue directory's four
        subdirectories exist, and its pending count; ``tcp://`` -> brokerd
        answers ``ping`` within 2 s, and its pending count; ``local://``
        -> the in-process worker pool's stats. (The reference sends every
        URL but ``local://`` to a redis probe.)"""
        url = settings.celery_broker_url
        if url.startswith("file://"):
            root = url[len("file://"):]
            subs = ("pending", "claimed", "state", "revoked")
            missing = [d for d in subs
                       if not os.path.isdir(os.path.join(root, d))]
            if missing:
                return _bad(f"queue directory {root} lacks {missing}",
                            backend="file")
            pending = sum(1 for n in os.listdir(os.path.join(root, "pending"))
                          if n.endswith(".json"))
            return _ok(backend="file", pending_tasks=pending)
        if url.startswith("tcp://"):
            from ..serve.brokerd import TcpBroker, parse_tcp_url

            try:
                broker = TcpBroker(*parse_tcp_url(url), timeout=2.0)
                try:
                    pong = broker.ping()
                    pending = broker.pending_count()
                finally:
                    broker.close()
            except (OSError, RuntimeError, ValueError) as e:
                return _bad(str(e), backend="tcp")
            if not pong:
                return _bad("brokerd did not answer ping", backend="tcp")
            return _ok(backend="tcp", pending_tasks=pending)
        if url in ("", "local://") or url.startswith("local://"):
            from ..serve.queue import task_queue

            return _ok(backend="local", **task_queue.stats())
        return _bad(f"unsupported CELERY_BROKER_URL {url!r}",
                    backend=url.split(":", 1)[0])

    # alias names matching the reference check set
    check_redis = check_queue
    check_celery = check_queue

    async def check_disk_space(self) -> Dict[str, Any]:
        """>1 GB free and <90% used (health.py disk check)."""
        if not _HAVE_PSUTIL:
            return _ok(skipped=True)
        disk = psutil.disk_usage("/")
        free_gb = disk.free / (1 << 30)
        pct = disk.percent
        info = {"free_gb": round(free_gb, 2), "used_percent": pct}
        if free_gb < 1.0 or pct > 90.0:
            return _bad("low disk space", **info)
        return _ok(**info)

    async def check_memory(self) -> Dict[str, Any]:
        """>500 MB available and <90% used (health.py memory check)."""
        if not _HAVE_PSUTIL:
            return _ok(skipped=True)
        mem = psutil.virtual_memory()
        avail_mb = mem.available / (1 << 20)
        info = {"available_mb": round(avail_mb, 1), "used_percent": mem.percent}
        if avail_mb < 500 or mem.percent > 90.0:
            return _bad("low memory", **info)
        return _ok(**info)

    async def check_model_files(self) -> Dict[str, Any]:
        """Model artifacts present (health.py:188: text_detector/
        text_recognizer checkpoints). Random-init is a valid mode, so
        missing files degrade rather than fail."""
        model_dir = settings.model_path
        expected = ["text_detector", "text_recognizer"]
        present = []
        if os.path.isdir(model_dir):
            names = os.listdir(model_dir)
            for stem in expected:
                if any(n.startswith(stem) for n in names):
                    present.append(stem)
        if len(present) == len(expected):
            return _ok(models=present)
        return _ok(
            models=present,
            warning=f"missing checkpoints: {set(expected) - set(present)} "
            "(running random-init)",
        )

    # A wedged runtime blocks the probe thread in block_until_ready
    # forever; periodic health polling must not stack a new leaked
    # thread (plus a queued device program) per poll — at most ONE
    # probe is ever outstanding, and later polls report unhealthy
    # immediately while it is stuck.
    _probe_lock = threading.Lock()
    _probe_thread = None

    async def check_accelerator(self) -> Dict[str, Any]:
        """Cards visible AND a trivial op completes within a deadline.
        Listing devices alone stays green while the runtime is wedged,
        so the probe runs a tiny op on the card and synchronises in a
        helper thread, and reports unhealthy on timeout rather than
        hanging the health endpoint. A cold CUDA context starts inside
        the probe (under a second on an H100)."""
        cls = type(self)
        with cls._probe_lock:
            if cls._probe_thread is not None and cls._probe_thread.is_alive():
                return _bad(
                    "accelerator probe still outstanding (runtime wedged?)"
                )

            result: Dict[str, Any] = {}

            def _probe():
                try:
                    result.update(cuda_probe())
                except Exception as e:  # noqa: BLE001
                    result["error"] = str(e)

            t = threading.Thread(target=_probe, daemon=True)
            cls._probe_thread = t
            t.start()
        t.join(timeout=PROBE_TIMEOUT_S)
        if t.is_alive():
            return _bad("accelerator probe timed out (runtime wedged?)")
        with cls._probe_lock:
            if cls._probe_thread is t:
                cls._probe_thread = None
        if "error" in result:
            return _bad(result["error"], probe="cuda")
        devs = result["devices"]
        return _ok(devices=devs, count=len(devs), probe="cuda")

    async def check_external_apis(self) -> Dict[str, Any]:
        """S3 head_bucket when configured (health.py:215-267)."""
        if not settings.s3_bucket_name:
            return _ok(skipped=True)
        try:
            import boto3  # type: ignore

            s3 = boto3.client("s3", region_name=settings.aws_region)
            s3.head_bucket(Bucket=settings.s3_bucket_name)
            return _ok(bucket=settings.s3_bucket_name)
        except Exception as e:
            return _bad(str(e))

    async def run_all(self) -> Dict[str, Dict[str, Any]]:
        checks: Dict[str, Callable] = {
            "database": self.check_database,
            "queue": self.check_queue,
            "disk": self.check_disk_space,
            "memory": self.check_memory,
            "models": self.check_model_files,
            "accelerator": self.check_accelerator,
            "external_apis": self.check_external_apis,
        }
        out = {}
        for name, fn in checks.items():
            try:
                out[name] = await fn()
            except Exception as e:
                out[name] = _bad(str(e))
        return out


class HealthMonitor:
    """30 s result cache + readiness/liveness (health.py:269-331)."""

    CRITICAL = ("database", "queue", "disk", "memory")
    LIVENESS = ("memory", "disk")

    def __init__(self, cache_seconds: float = 30.0):
        self.checker = HealthCheck()
        self.cache_seconds = cache_seconds
        self._cache: Optional[Dict[str, Any]] = None
        self._cache_time = 0.0

    async def get_health(self, force: bool = False) -> Dict[str, Any]:
        now = time.time()
        if (
            not force
            and self._cache is not None
            and now - self._cache_time < self.cache_seconds
        ):
            return self._cache
        checks = await self.checker.run_all()
        overall = all(
            c.get("status") == "healthy" for c in checks.values()
        )
        self._cache = {
            "status": "healthy" if overall else "degraded",
            "checks": checks,
            "timestamp": now,
        }
        self._cache_time = now
        return self._cache

    async def readiness(self) -> Dict[str, Any]:
        health = await self.get_health()
        ready = all(
            health["checks"].get(c, {}).get("status") == "healthy"
            for c in self.CRITICAL
        )
        return {"ready": ready, "checks": {
            c: health["checks"].get(c, {}).get("status") for c in self.CRITICAL
        }}

    async def liveness(self) -> Dict[str, Any]:
        health = await self.get_health()
        alive = all(
            health["checks"].get(c, {}).get("status") == "healthy"
            for c in self.LIVENESS
        )
        return {"alive": alive}


health_monitor = HealthMonitor()
