"""Task queue — Celery-compatible semantics without Celery (port of
``vtd_tpu/serve/queue.py``, thread worker only).

The reference distributes work via Celery over Redis (reference
``app/celery_app.py``); here the queue is an in-process thread-pool
worker, one process driving the card, with Celery-shaped semantics:

  * ``@task_queue.task(name=..., queue=...)`` decorator producing
    ``.delay(*args)`` -> ``AsyncResult`` with ``.id``, ``.state``,
    ``.info``
  * states PENDING / STARTED / PROGRESS / SUCCESS / FAILURE / REVOKED
    (``task_track_started`` parity, celery_app.py:20)
  * ``revoke(task_id, terminate=...)`` (best-effort: running tasks see a
    cancellation flag; queued tasks are dropped)
  * soft/hard time limits (celery_app.py:23-24) enforced by a monitor
  * periodic beat schedule (celery_app.py:35-44)
  * prerun/postrun/failure signal hooks (celery_app.py:54-105)
  * worker stats for ``get_celery_stats()`` parity (celery_app.py:109-129)

The reference's cross-host brokers (``file://``, ``tcp://``) and its
process pool (``worker_pool="process"``) wait for the next slice of the
port (ROADMAP queue 1 item 9) and raise NotImplementedError here.
"""
from __future__ import annotations

import logging
import queue as _queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

NEXT_SLICE = (
    "waits for the next slice of the port (ROADMAP queue 1 item 9: the "
    "broker, brokerd and the process pool)"
)

STATES = ("PENDING", "STARTED", "PROGRESS", "SUCCESS", "FAILURE", "REVOKED")


@dataclass
class TaskRecord:
    id: str
    name: str
    args: tuple
    kwargs: dict
    queue: str = "default"
    state: str = "PENDING"
    info: Any = None
    result: Any = None
    traceback: str = ""
    submitted_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    cancel_event: threading.Event = field(default_factory=threading.Event)
    # Explicit revocation (vs a soft-time-limit nudge, which also sets
    # cancel_event): only this makes a completed task report REVOKED.
    revoke_requested: bool = False


class AsyncResult:
    """Celery-shaped handle (processing_service.py:30-49 reads .state,
    .info, .traceback, .ready, .successful)."""

    def __init__(self, task_id: str, backend: "TaskQueue"):
        self.id = task_id
        self._backend = backend

    @property
    def _rec(self) -> Optional[TaskRecord]:
        return self._backend.get_record(self.id)

    @property
    def state(self) -> str:
        rec = self._rec
        return rec.state if rec else "PENDING"

    status = state

    @property
    def info(self) -> Any:
        rec = self._rec
        return rec.info if rec else None

    @property
    def result(self) -> Any:
        rec = self._rec
        return rec.result if rec else None

    @property
    def traceback(self) -> str:
        rec = self._rec
        return rec.traceback if rec else ""

    def ready(self) -> bool:
        return self.state in ("SUCCESS", "FAILURE", "REVOKED")

    def successful(self) -> bool:
        return self.state == "SUCCESS"

    def get(self, timeout: Optional[float] = None) -> Any:
        deadline = time.time() + timeout if timeout else None
        while not self.ready():
            if deadline and time.time() > deadline:
                raise TimeoutError(f"task {self.id} not done")
            time.sleep(0.01)
        rec = self._rec
        if rec.state == "FAILURE":
            raise RuntimeError(rec.traceback or str(rec.result))
        return rec.result


class TaskContext:
    """Passed as the task's ``self`` (Celery bind=True parity):
    ``update_state`` and a cancellation check."""

    def __init__(self, rec: TaskRecord, backend: "TaskQueue"):
        self.request = rec
        self._backend = backend

    @property
    def id(self) -> str:
        return self.request.id

    def update_state(self, state: str = "PROGRESS", meta: Any = None):
        self.request.state = state
        self.request.info = meta

    def is_revoked(self) -> bool:
        return self.request.cancel_event.is_set()


class RegisteredTask:
    def __init__(self, fn: Callable, name: str, queue: str, backend: "TaskQueue"):
        self.fn = fn
        self.name = name
        self.queue = queue
        self._backend = backend

    def delay(self, *args, **kwargs) -> AsyncResult:
        return self._backend.submit(self, args, kwargs)

    def apply_async(
        self, args=(), kwargs=None, task_id: Optional[str] = None, **_
    ) -> AsyncResult:
        # task_id lets callers persist the id (e.g. a ProcessingJob row)
        # BEFORE the task can run — Celery's apply_async(task_id=...)
        # contract; without it a fast worker races the row insert.
        return self._backend.submit(
            self, tuple(args), kwargs or {}, task_id=task_id
        )

    def __call__(self, *args, **kwargs):
        return self.fn(None, *args, **kwargs)


class TaskQueue:
    """Thread-pool worker with beat scheduling and signal hooks."""

    def __init__(
        self,
        concurrency: int = 2,
        soft_time_limit: float = 3000.0,
        hard_time_limit: float = 3600.0,
        worker_kind: str = "thread",
    ):
        if worker_kind != "thread":
            raise NotImplementedError(
                f"worker_kind={worker_kind!r} {NEXT_SLICE}"
            )
        self.tasks: Dict[str, RegisteredTask] = {}
        self.records: Dict[str, TaskRecord] = {}
        self._q: _queue.Queue = _queue.Queue()
        self._workers: List[threading.Thread] = []
        self._beat: List[tuple] = []  # (interval_s, RegisteredTask, args)
        self._beat_thread: Optional[threading.Thread] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.concurrency = concurrency
        self.soft_time_limit = soft_time_limit
        self.hard_time_limit = hard_time_limit
        self.on_prerun: List[Callable] = []
        self.on_postrun: List[Callable] = []
        self.on_failure: List[Callable] = []
        self._stats = {"completed": 0, "failed": 0, "revoked": 0}

    # -- registration ----------------------------------------------------
    def task(self, name: str = "", queue: str = "default"):
        def deco(fn: Callable) -> RegisteredTask:
            t = RegisteredTask(fn, name or fn.__name__, queue, self)
            self.tasks[t.name] = t
            return t

        return deco

    def add_periodic_task(
        self, interval_s: float, task: RegisteredTask, args: tuple = ()
    ):
        self._beat.append((interval_s, task, args))

    # -- submission --------------------------------------------------------
    def submit(
        self, task: RegisteredTask, args: tuple, kwargs: dict,
        task_id: Optional[str] = None,
    ) -> AsyncResult:
        rec = TaskRecord(
            id=task_id or str(uuid.uuid4()), name=task.name, args=args,
            kwargs=kwargs, queue=task.queue,
        )
        with self._lock:
            self.records[rec.id] = rec
        self._q.put(rec)
        self._ensure_workers()
        return AsyncResult(rec.id, self)

    def get_record(self, task_id: str) -> Optional[TaskRecord]:
        return self.records.get(task_id)

    def revoke(self, task_id: str, terminate: bool = False) -> bool:
        """Queued tasks are dropped; a running task sees its cancellation
        flag at its next progress point (a thread cannot be killed, so
        ``terminate`` changes nothing here)."""
        rec = self.records.get(task_id)
        if not rec:
            return False
        rec.revoke_requested = True
        rec.cancel_event.set()
        if rec.state == "PENDING":
            rec.state = "REVOKED"
            rec.finished_at = time.time()
            self._stats["revoked"] += 1
        return True

    # -- workers -----------------------------------------------------------
    def start_workers(self):
        """Start worker/beat/monitor threads without a submission."""
        self._ensure_workers()

    def _ensure_workers(self):
        with self._lock:
            alive = [w for w in self._workers if w.is_alive()]
            self._workers = alive
            while len(self._workers) < self.concurrency:
                t = threading.Thread(target=self._worker_loop, daemon=True)
                t.start()
                self._workers.append(t)
            if self._beat and self._beat_thread is None:
                self._beat_thread = threading.Thread(
                    target=self._beat_loop, daemon=True
                )
                self._beat_thread.start()
            if self._monitor_thread is None:
                self._monitor_thread = threading.Thread(
                    target=self._monitor_loop, daemon=True
                )
                self._monitor_thread.start()

    def _worker_loop(self):
        while not self._stop.is_set():
            try:
                rec = self._q.get(timeout=0.2)
            except _queue.Empty:
                continue
            if rec.cancel_event.is_set():
                continue  # revoked while queued
            self._run(rec)

    def _gc_records(self, keep: int = 2000):
        """Bound the in-memory task-record store: drop the oldest
        finished records beyond ``keep`` (Celery offloads this to the
        result backend's TTL; the local backend prunes in place)."""
        with self._lock:
            done = [
                r
                for r in self.records.values()
                if r.state in ("SUCCESS", "FAILURE", "REVOKED")
            ]
            if len(done) <= keep:
                return
            done.sort(key=lambda r: r.finished_at or 0)
            for r in done[: len(done) - keep]:
                self.records.pop(r.id, None)

    def _monitor_loop(self):
        """Enforce soft/hard time limits (celery_app.py:23-24 parity):
        past the soft limit a task sees its cancellation flag; past the
        hard limit it is marked FAILURE (threads can't be force-killed,
        but tasks poll ``is_revoked`` at progress points)."""
        while not self._stop.is_set():
            now = time.time()
            for rec in list(self.records.values()):
                if rec.state not in ("STARTED", "PROGRESS"):
                    continue
                elapsed = now - (rec.started_at or now)
                if elapsed > self.soft_time_limit:
                    rec.cancel_event.set()
                # hard limit only after the soft cancellation had a
                # chance to be observed (separate monitor passes)
                if elapsed > self.hard_time_limit and rec.cancel_event.is_set():
                    rec.result = "hard time limit exceeded"
                    rec.state = "FAILURE"
                    rec.finished_at = now
                    self._stats["failed"] += 1
                    # The task body never returns, so its own cleanup
                    # can't run: deliver the failure/postrun signals here
                    # (DB-sync hooks depend on them).
                    err = TimeoutError("hard time limit exceeded")
                    for hook in self.on_failure:
                        _safe(hook, rec, err)
                    for hook in self.on_postrun:
                        _safe(hook, rec)
            self._gc_records()
            self._stop.wait(0.25)

    def _run(self, rec: TaskRecord):
        task = self.tasks.get(rec.name)
        if task is None:
            rec.result = f"unknown task {rec.name}"
            rec.state = "FAILURE"
            return
        rec.state = "STARTED"
        rec.started_at = time.time()
        ctx = TaskContext(rec, self)
        for hook in self.on_prerun:
            _safe(hook, rec)
        try:
            rec.result = task.fn(ctx, *rec.args, **rec.kwargs)
            if rec.revoke_requested:
                rec.state = "REVOKED"
                self._stats["revoked"] += 1
            else:
                # A soft-time-limit nudge the task outran (or ignored)
                # is still a success — Celery parity.
                rec.state = "SUCCESS"
                self._stats["completed"] += 1
        except Exception as e:
            # result/traceback BEFORE state: waiters poll state as the
            # publication flag and read the others once it flips
            rec.result = str(e)
            rec.traceback = traceback.format_exc()
            rec.state = "FAILURE"
            self._stats["failed"] += 1
            for hook in self.on_failure:
                _safe(hook, rec, e)
            logger.error("task %s failed: %s", rec.name, e)
        finally:
            rec.finished_at = time.time()
            for hook in self.on_postrun:
                _safe(hook, rec)

    def _beat_loop(self):
        # keyed with .get(): register_beat_schedule may append entries
        # after this thread started (second create_app in one process)
        last: Dict[int, float] = {}
        while not self._stop.is_set():
            now = time.time()
            for i, (interval, task, args) in enumerate(list(self._beat)):
                if now - last.get(i, 0.0) >= interval:
                    last[i] = now
                    _safe(task.delay, *args)
            self._stop.wait(0.5)

    # -- introspection (get_celery_stats parity, celery_app.py:109-129) ---
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            active = [
                r.name for r in self.records.values() if r.state == "STARTED"
            ]
            pending = self._q.qsize()
        workers = len([w for w in self._workers if w.is_alive()])
        return {
            "workers": workers,
            "active_tasks": active,
            "pending_tasks": pending,
            **self._stats,
        }

    def shutdown(self):
        self._stop.set()


def _safe(fn, *args):
    try:
        fn(*args)
    except Exception:  # signal hooks must never kill the worker
        logger.exception("task signal hook failed")


def _broker_from_settings():
    """Settings-driven broker (reference celery_app.py:14-16): this slice
    serves only ``local://``, the in-process queue (None). The
    reference's ``file://`` and ``tcp://`` brokers raise
    NotImplementedError; any other scheme raises ValueError as in the
    reference, because an unknown URL silently degrading to the
    in-process queue would turn an intended fleet into one node."""
    from ..core.config import settings

    url = settings.celery_broker_url
    if url in ("", "local://") or url.startswith("local://"):
        return None
    if url.startswith(("file://", "tcp://")):
        raise NotImplementedError(f"CELERY_BROKER_URL={url!r} {NEXT_SLICE}")
    raise ValueError(
        f"unsupported CELERY_BROKER_URL scheme: {url!r} — use "
        "'local://' (in-process, single node); redis:// is not a "
        "supported transport"
    )


def _worker_kind_from_settings() -> str:
    from ..core.config import settings

    return getattr(settings, "worker_pool", "thread")


# Module-level default queue (the reference's module-level celery_app).
_broker_from_settings()
task_queue = TaskQueue(worker_kind=_worker_kind_from_settings())
