"""Task queue — Celery-compatible semantics without Celery (port of
``vtd_tpu/serve/queue.py``).

The reference distributes work via Celery over Redis (reference
``app/celery_app.py``); here the queue is an in-process worker pool with
Celery-shaped semantics:

  * ``@task_queue.task(name=..., queue=...)`` decorator producing
    ``.delay(*args)`` -> ``AsyncResult`` with ``.id``, ``.state``,
    ``.info``
  * states PENDING / STARTED / PROGRESS / SUCCESS / FAILURE / REVOKED
    (``task_track_started`` parity, celery_app.py:20)
  * ``revoke(task_id, terminate=...)`` (best-effort on threads: running
    tasks see a cancellation flag; queued tasks are dropped; the process
    pool SIGKILLs a running task's child)
  * soft/hard time limits (celery_app.py:23-24) enforced by a monitor
  * periodic beat schedule (celery_app.py:35-44)
  * prerun/postrun/failure signal hooks (celery_app.py:54-105)
  * worker stats for ``get_celery_stats()`` parity (celery_app.py:109-129)

Multi-host fleets share one broker (``settings.celery_broker_url``):
``file:///shared/dir`` (serve/broker.py) or ``tcp://host:port``
(serve/brokerd.py); ``worker_pool="process"`` runs tasks in spawned
children that the hard time limit can kill (serve/procworker.py).
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
        broker = self._backend.broker
        if broker is not None:
            broker.set_state(self.id, {"state": state, "info": meta})
            broker.heartbeat(self.id)

    def is_revoked(self) -> bool:
        if self.request.cancel_event.is_set():
            return True
        broker = self._backend.broker
        if broker is not None and broker.is_revoked(self.id):
            self.request.cancel_event.set()
            return True
        return False


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
        broker=None,
        worker_kind: str = "thread",
        tasks_module: str = "vtd_tpu_torch.serve.tasks",
        max_tasks_per_child: int = 10,
    ):
        # broker: optional external work queue (serve/broker.FileBroker
        # protocol) for multi-host fleets — N worker processes/hosts
        # drain one shared queue, Celery-over-Redis style (reference
        # app/celery_app.py:14-34). None = in-process queue.
        self.broker = broker
        # worker_kind="process": Celery-prefork semantics — child
        # processes that the hard time limit (and revoke(terminate=True))
        # can actually SIGKILL, with max_tasks_per_child recycling
        # (serve/procworker.py), each with its own CUDA context. "thread"
        # (default) marks-but-can't-stop past the hard limit; its worker
        # threads share one pipeline and one CUDA context.
        self.worker_kind = worker_kind
        self.tasks_module = tasks_module
        self.max_tasks_per_child = max_tasks_per_child
        self._pool = None  # ProcessWorkerPool, created lazily
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
        if self.broker is not None:
            self.broker.enqueue(rec.id, rec.name, args, kwargs, rec.queue)
            self._ensure_workers()
        elif self.worker_kind == "process":
            self._ensure_workers()
            self._pool.submit(rec)
        else:
            self._q.put(rec)
            self._ensure_workers()
        return AsyncResult(rec.id, self)

    def get_record(self, task_id: str) -> Optional[TaskRecord]:
        rec = self.records.get(task_id)
        if self.broker is None:
            return rec
        # Brokered: the task may be running on another host — merge the
        # shared state over the local record (or synthesize one).
        state = self.broker.get_state(task_id)
        if state is None:
            return rec
        if rec is None:
            rec = TaskRecord(id=task_id, name="", args=(), kwargs={})
            self.records[task_id] = rec
        if rec.state not in ("SUCCESS", "FAILURE", "REVOKED"):
            rec.state = state.get("state", rec.state)
            rec.info = state.get("info", rec.info)
            if "result" in state:
                rec.result = state["result"]
            if "traceback" in state:
                rec.traceback = state["traceback"]
        return rec

    def revoke(self, task_id: str, terminate: bool = False) -> bool:
        if self.broker is not None:
            self.broker.revoke(task_id)
        rec = self.records.get(task_id)
        if not rec:
            return self.broker is not None
        rec.revoke_requested = True
        rec.cancel_event.set()
        if self._pool is not None:
            self._pool.revoke(task_id, terminate=terminate)
        if rec.state == "PENDING":
            rec.state = "REVOKED"
            rec.finished_at = time.time()
            self._stats["revoked"] += 1
            if self.broker is not None:
                self.broker.set_state(task_id, {"state": "REVOKED"})
        return True

    # -- workers -----------------------------------------------------------
    def start_workers(self):
        """Start worker/beat/monitor threads without a submission — how a
        dedicated worker process (multi-host fleet) attaches to a shared
        broker and starts draining it."""
        self._ensure_workers()

    def _ensure_workers(self):
        if self.worker_kind == "process" and self.broker is None:
            with self._lock:
                if self._pool is None:
                    from .procworker import ProcessWorkerPool

                    self._pool = ProcessWorkerPool(
                        self,
                        tasks_module=self.tasks_module,
                        concurrency=self.concurrency,
                        max_tasks_per_child=self.max_tasks_per_child,
                    )
                if self._beat and self._beat_thread is None:
                    self._beat_thread = threading.Thread(
                        target=self._beat_loop, daemon=True
                    )
                    self._beat_thread.start()
                if self._monitor_thread is None:
                    # ProcessWorkerPool enforces time limits itself; the
                    # queue still needs the record GC (and nothing else)
                    # or records grow without bound on long-lived hosts.
                    self._monitor_thread = threading.Thread(
                        target=self._gc_loop, daemon=True
                    )
                    self._monitor_thread.start()
            return
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
            if self.broker is not None:
                # One NFS hiccup or malformed task file must not kill a
                # fleet worker thread permanently.
                try:
                    payload = self.broker.claim()
                    if payload is None:
                        self._stop.wait(0.1)
                        continue
                    rec = self.records.get(payload["id"])
                    if rec is None or rec.name == "":
                        rec = TaskRecord(
                            id=payload["id"], name=payload["name"],
                            args=tuple(payload.get("args", ())),
                            kwargs=payload.get("kwargs", {}),
                            queue=payload.get("queue", "default"),
                        )
                        self.records[rec.id] = rec
                    self._run(rec)
                    self.broker.finish(rec.id)
                except Exception:
                    logger.exception("broker worker iteration failed")
                    self._stop.wait(1.0)
                continue
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

    def _gc_loop(self):
        while not self._stop.is_set():
            self._gc_records()
            self._stop.wait(5.0)

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
            if self.broker is not None:
                # keep shared-queue heartbeats fresh for tasks running
                # here (started_at is set by _run only, never by a merge
                # of another host's state in get_record, so a producer
                # polling a job does not keep a dead worker's claim
                # alive), and reclaim tasks from dead workers
                for rec in list(self.records.values()):
                    if (rec.state in ("STARTED", "PROGRESS")
                            and rec.started_at is not None):
                        _safe(self.broker.heartbeat, rec.id)
                _safe(self.broker.requeue_stale)
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
        if self.broker is not None:
            # Advisory only — a transient broker error here (daemon
            # restart mid-claim) must not abort a claimed task: the
            # local record is already STARTED, so an exception would
            # leave the monitor heartbeating a task that never runs
            # until the hard time limit fires.
            _safe(self.broker.set_state, rec.id, {"state": "STARTED"})
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
                # is still a success — Celery parity: tasks that swallow
                # SoftTimeLimitExceeded and return keep their result.
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
            if self.broker is not None:
                final = {"state": rec.state, "traceback": rec.traceback}
                try:  # results ride the shared state file when JSON-able
                    import json as _json

                    _json.dumps(rec.result)
                    final["result"] = rec.result
                except (TypeError, ValueError):
                    final["result"] = repr(rec.result)
                self.broker.set_state(rec.id, final)
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
        workers = (
            self._pool.alive_workers()
            if self._pool is not None
            else len([w for w in self._workers if w.is_alive()])
        )
        return {
            "workers": workers,
            "active_tasks": active,
            "pending_tasks": pending,
            **self._stats,
        }

    def shutdown(self):
        self._stop.set()
        if self._pool is not None:
            self._pool.shutdown()


def _safe(fn, *args):
    try:
        fn(*args)
    except Exception:  # signal hooks must never kill the worker
        logger.exception("task signal hook failed")


def _broker_from_settings():
    """Settings-driven broker (reference celery_app.py:14-16 reads its
    broker URL from settings the same way): ``file:///shared/dir`` mounts
    a FileBroker on a shared filesystem, ``tcp://host:port`` connects to
    ``brokerd``; ``local://`` = in-process (None).

    Any other scheme raises: an unknown URL silently degrading to the
    in-process queue would turn an intended multi-host fleet into a
    single-node deployment with no error (a ``redis://`` URL from a
    reference-style deployment must fail fast here)."""
    from ..core.config import settings

    url = settings.celery_broker_url
    if url.startswith("file://"):
        from .broker import FileBroker

        return FileBroker(url[len("file://"):])
    if url.startswith("tcp://"):
        from .brokerd import TcpBroker, parse_tcp_url

        return TcpBroker(*parse_tcp_url(url))
    if url in ("", "local://") or url.startswith("local://"):
        return None  # in-process queue (single-node default)
    raise ValueError(
        f"unsupported CELERY_BROKER_URL scheme: {url!r} — use "
        "'local://' (in-process, single node), 'file:///shared/dir' "
        "(FileBroker on a shared filesystem), or 'tcp://host:port' "
        "(the brokerd network broker) for multi-host fleets; redis:// is "
        "not a supported transport"
    )


def _worker_kind_from_settings() -> str:
    from ..core.config import settings

    return getattr(settings, "worker_pool", "thread")


# Module-level default queue (the reference's module-level celery_app).
task_queue = TaskQueue(
    broker=_broker_from_settings(),
    worker_kind=_worker_kind_from_settings(),
)
