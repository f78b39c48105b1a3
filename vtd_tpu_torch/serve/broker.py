"""Multi-host work distribution: a shared-filesystem task broker (port
of ``vtd_tpu/serve/broker.py``; the on-disk layout is the same, so a
port worker and a ``vtd_tpu`` worker can drain one queue directory).

The reference distributes whole-video tasks to N GPU workers through a
Redis broker (reference ``app/celery_app.py:14-34``, worker replicas in
``k8s/deployment.yaml:127-189``). This broker lives on a shared
filesystem (NFS and the like), with no extra server process:

  * enqueue: atomic write into ``pending/`` (tmp + rename)
  * claim: ``os.rename(pending/<id>.json, claimed/<id>.json)`` — rename
    is atomic on POSIX, so exactly one worker wins a task
  * state/result: per-task JSON in ``state/`` (atomic replace)
  * revoke: marker files in ``revoked/``
  * elasticity: claimed tasks carry a heartbeat file; a reaper requeues
    tasks whose worker stopped heartbeating (preemption / OOM kill),
    so a preempted video job restarts on another host — and resumes
    from its frame checkpoint (serve/tasks.py), not frame 0.

Any object with this class's methods can back ``TaskQueue``
(``serve/brokerd.py:TcpBroker`` is the network one).
"""
from __future__ import annotations

import json
import logging
import os
import socket
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class FileBroker:
    def __init__(
        self,
        root: str,
        worker_id: Optional[str] = None,
        heartbeat_timeout: float = 30.0,
        result_ttl: float = 86400.0,
    ):
        self.root = Path(root)
        for sub in ("pending", "claimed", "state", "revoked"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)
        self.worker_id = worker_id or f"{socket.gethostname()}-{os.getpid()}"
        self.heartbeat_timeout = heartbeat_timeout
        # state/ holds results other hosts poll after completion — they
        # expire after result_ttl (Celery result-backend TTL parity)
        # instead of accumulating one file per task forever.
        self.result_ttl = result_ttl
        self._last_gc = 0.0
        # task id -> when this reaper first saw its claim without a
        # heartbeat file (see requeue_stale)
        self._unbeaten: Dict[str, float] = {}

    # -- paths -------------------------------------------------------------
    def _p(self, sub: str, task_id: str, ext: str = ".json") -> Path:
        return self.root / sub / f"{task_id}{ext}"

    def _atomic_write(self, path: Path, payload: Dict[str, Any]) -> None:
        tmp = path.parent / f".{path.name}.{uuid.uuid4().hex}.tmp"
        tmp.write_text(json.dumps(payload))
        os.replace(tmp, path)

    # -- producer ------------------------------------------------------------
    def enqueue(self, task_id: str, name: str, args: tuple, kwargs: dict,
                queue: str = "default") -> None:
        payload = {
            "id": task_id, "name": name, "args": list(args),
            "kwargs": kwargs, "queue": queue, "submitted_at": time.time(),
        }
        self.set_state(task_id, {"state": "PENDING"})
        self._atomic_write(self._p("pending", task_id), payload)

    # -- consumer ------------------------------------------------------------
    def claim(self) -> Optional[Dict[str, Any]]:
        """Atomically take one pending task; None when queue is empty."""
        try:
            # FIFO: uuid filenames sort randomly — order by mtime (the
            # enqueue time) so a task can't be starved behind
            # later-submitted tasks with smaller uuids.
            with os.scandir(self.root / "pending") as it:
                entries = [
                    (e.stat().st_mtime, e.name)
                    for e in it
                    if e.name.endswith(".json")
                ]
        except (FileNotFoundError, OSError):
            return None
        for _, name in sorted(entries):
            src = self.root / "pending" / name
            dst = self.root / "claimed" / name
            try:
                os.rename(src, dst)  # atomic: one winner
            except OSError:
                continue  # another worker got it
            try:
                payload = json.loads(dst.read_text())
            except ValueError:
                logger.warning("dropping corrupt task file %s", name)
                dst.unlink(missing_ok=True)
                continue
            if self.is_revoked(payload["id"]):
                dst.unlink(missing_ok=True)
                self.set_state(payload["id"], {"state": "REVOKED"})
                continue
            payload["claimed_by"] = self.worker_id
            self.heartbeat(payload["id"])
            return payload
        return None

    def heartbeat(self, task_id: str) -> None:
        self._atomic_write(
            self._p("claimed", task_id, ".hb"),
            {"worker": self.worker_id, "ts": time.time()},
        )

    def finish(self, task_id: str) -> None:
        self._p("claimed", task_id).unlink(missing_ok=True)
        self._p("claimed", task_id, ".hb").unlink(missing_ok=True)
        # The revoke marker has served its purpose once the task is done.
        self._p("revoked", task_id).unlink(missing_ok=True)

    # -- state / results -------------------------------------------------------
    def set_state(self, task_id: str, state: Dict[str, Any]) -> None:
        state = dict(state, updated_at=time.time())
        self._atomic_write(self._p("state", task_id), state)

    def get_state(self, task_id: str) -> Optional[Dict[str, Any]]:
        p = self._p("state", task_id)
        try:
            return json.loads(p.read_text())
        except (FileNotFoundError, ValueError):
            return None

    # -- revocation -------------------------------------------------------------
    def revoke(self, task_id: str) -> None:
        self._atomic_write(self._p("revoked", task_id), {"ts": time.time()})

    def is_revoked(self, task_id: str) -> bool:
        return self._p("revoked", task_id).exists()

    # -- elasticity -----------------------------------------------------------
    def requeue_stale(self) -> List[str]:
        """Requeue claimed tasks whose worker heartbeat went stale
        (worker preempted/crashed). Returns the requeued ids."""
        requeued = []
        now = time.time()
        unbeaten: Dict[str, float] = {}
        for name in list(os.listdir(self.root / "claimed")):
            if not name.endswith(".json"):
                continue
            task_id = name[: -len(".json")]
            hb = self._p("claimed", task_id, ".hb")
            try:
                ts = json.loads(hb.read_text())["ts"]
            except FileNotFoundError:
                # claim() renames the task first and writes its first
                # heartbeat just after: a claim without one ages from
                # when this reaper first saw it, so a claim in flight is
                # never taken back (the reference requeues it at once,
                # and the task then runs twice).
                ts = unbeaten[task_id] = self._unbeaten.get(task_id, now)
            except (ValueError, KeyError):
                ts = 0.0
            if now - ts < self.heartbeat_timeout:
                continue
            unbeaten.pop(task_id, None)
            src = self._p("claimed", task_id)
            dst = self._p("pending", task_id)
            try:
                os.rename(src, dst)  # atomic: one reaper wins
            except OSError:
                continue
            hb.unlink(missing_ok=True)
            self.set_state(task_id, {"state": "PENDING", "requeued": True})
            requeued.append(task_id)
            logger.warning("requeued stale task %s", task_id)
        self._unbeaten = unbeaten
        self._gc_expired(now)
        return requeued

    def _gc_expired(self, now: float) -> None:
        """Drop state files and revoke markers past result_ttl — the
        only files finish() can't remove (results are read after
        completion). Runs from the periodic requeue_stale sweep, at
        most every 5 minutes."""
        if now - self._last_gc < 300.0:
            return
        self._last_gc = now
        cutoff = now - self.result_ttl
        for sub in ("state", "revoked"):
            try:
                with os.scandir(self.root / sub) as it:
                    stale = [
                        e.path for e in it
                        if not e.name.startswith(".")
                        and e.stat().st_mtime < cutoff
                    ]
            except (FileNotFoundError, OSError):
                continue
            for path in stale:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def pending_count(self) -> int:
        try:
            return sum(
                1
                for n in os.listdir(self.root / "pending")
                if n.endswith(".json")
            )
        except FileNotFoundError:
            return 0
