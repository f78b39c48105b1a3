"""Process-based worker pool — Celery prefork parity (port of
``vtd_tpu/serve/procworker.py``).

The thread-pool backend (serve/queue.py) cannot force-stop a task: past
the hard time limit it can only *mark* the task FAILURE while the thread
runs on. Celery's prefork pool kills the child process outright
(reference ``app/celery_app.py:23-24`` sets the 3600 s hard limit that
billiard enforces with SIGKILL, and ``worker_max_tasks_per_child=10``
recycles workers, ``:26``). This pool reproduces those semantics:

  * N long-lived child processes (spawn), each importing the task module
    once (models load once per child — the reference's singleton
    pipeline pattern, ``app/tasks/video_processing.py:32-37``)
  * hard time limit / ``revoke(terminate=True)`` => SIGKILL the child,
    mark the task, respawn a fresh child
  * ``max_tasks_per_child`` recycling
  * a crashed child (OOM, segfault) is detected and its in-flight task
    marked FAILURE ("worker lost") — Celery's WorkerLostError parity

Use ``TaskQueue(worker_kind="process")`` to enable. On the card: each
child opens its own CUDA context (which ``spawn`` makes safe once the
parent has touched CUDA) and builds its own pipeline, so a child pays
the torch import, the context and its first ``process_video`` before its
first job ends; a SIGKILLed child's context goes with its process
and its siblings keep theirs. Settings reach a child only through the
environment it inherits: ``serve`` and ``worker`` put ``--device`` there
as ``DEVICE``.

Design: the parent DISPATCHES each task to a specific idle child's own
inbox queue and records the assignment first, so even a child that dies
before flushing any event (os._exit, OOM kill) leaves an attributable
in-flight task. Events ("started" | "state" | "done" | "recycled") ride
a PER-CHILD one-way pipe back (parent write-end closed, so a dead
child reads as EOF, never a block) — a child SIGKILLed mid-``send``
can only tear its own channel, never stall event delivery from its
siblings (the failure mode that pushed Celery onto billiard instead
of raw kills on a shared mp.Queue). Drains are serialized per child.
Revocation flags are shared through a Manager dict the child polls in
``is_revoked``.

The parent counts the payloads it sends each child and sends none past
``max_tasks_per_child``: a child reads no more before it recycles. A
task held by a child that dies before its "started" event goes back on
the pending queue, once: a second child that dies the same way (a task
module that does not import, a card that does not start) fails it as
"worker lost", as does the death of a child that started it. The
reference dispatches to a child between its last "done" and its
"recycled", and loses that task.
"""
from __future__ import annotations

import importlib
import logging
import multiprocessing as mp
import os
import queue as _queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict

logger = logging.getLogger(__name__)


class _ChildTaskContext:
    """Task ``self`` inside a child process: state updates flow to the
    parent over the event pipe; revocation flags come from the shared
    dict."""

    def __init__(self, task_id: str, event_w, revoked):
        self.id = task_id
        self._event_w = event_w
        self._revoked = revoked

    def update_state(self, state: str = "PROGRESS", meta: Any = None):
        self._event_w.send(("state", self.id, state, meta))

    def is_revoked(self) -> bool:
        return self._revoked.get(self.id) is not None

    def _explicitly_revoked(self) -> bool:
        return self._revoked.get(self.id) == "revoke"


def task_registry(tasks_module: str) -> Dict[str, Any]:
    """Import ``tasks_module`` and return its tasks by name: those it
    registered with ``@task_queue.task`` on this process's module-level
    queue, and module attributes with a ``name`` and an ``fn`` (the
    latter win)."""
    mod = importlib.import_module(tasks_module)
    from .queue import task_queue

    registry: Dict[str, Any] = dict(task_queue.tasks)
    for attr in vars(mod).values():
        name = getattr(attr, "name", None)
        if name and hasattr(attr, "fn"):
            registry[name] = attr
    return registry


def child_main(inbox, event_w, revoked, tasks_module: str, max_tasks: int):
    """Child process loop: import the task module (registering its tasks
    on the child's own module-level queue), then drain the inbox.
    Top-level so spawn can import it."""
    import traceback as _tb

    registry = task_registry(tasks_module)

    done = 0
    while max_tasks <= 0 or done < max_tasks:
        payload = inbox.get()
        if payload is None:
            return
        tid = payload["id"]
        event_w.send(("started", tid, os.getpid()))
        ctx = _ChildTaskContext(tid, event_w, revoked)
        task = registry.get(payload["name"])
        try:
            if task is None:
                raise LookupError(f"unknown task {payload['name']}")
            result = task.fn(
                ctx, *tuple(payload.get("args", ())),
                **payload.get("kwargs", {}),
            )
            # Only an explicit revoke makes a completed task REVOKED; a
            # soft-time-limit nudge the task outran is still a success
            # (Celery parity — see queue.py:_run).
            state = "REVOKED" if ctx._explicitly_revoked() else "SUCCESS"
            event_w.send(("done", tid, state, _jsonable(result), ""))
        except InterruptedError:
            event_w.send(("done", tid, "REVOKED", None, ""))
        except Exception as e:  # noqa: BLE001 — report, keep draining
            event_w.send(("done", tid, "FAILURE", str(e), _tb.format_exc()))
        done += 1
    event_w.send(("recycled", os.getpid(), None))


def _jsonable(value):
    import json

    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return repr(value)


@dataclass
class _Child:
    proc: Any
    inbox: Any
    event_r: Any  # read end of the child's event pipe
    # Serializes drains: the event pump, the monitor loop, and kill
    # paths may all try to read this child's events — two concurrent
    # readers on one Connection can interleave recv()s and block.
    drain_lock: Any
    sent: int = 0  # payloads put into ``inbox``


class ProcessWorkerPool:
    """Parent-side pool manager. Integrates with TaskQueue: the queue
    submits records via :meth:`submit` and this pool keeps
    ``queue.records`` updated from child events."""

    def __init__(
        self,
        queue_backend,
        tasks_module: str = "vtd_tpu_torch.serve.tasks",
        concurrency: int = 2,
        max_tasks_per_child: int = 10,
    ):
        self._backend = queue_backend
        self._tasks_module = tasks_module
        self._concurrency = concurrency
        self._max_tasks = max_tasks_per_child
        ctx = mp.get_context("spawn")
        self._ctx = ctx
        self._manager = ctx.Manager()
        self.revoked = self._manager.dict()
        self._pending: "_queue.Queue" = _queue.Queue()
        self._children: Dict[int, _Child] = {}
        self._assigned: Dict[int, str] = {}  # pid -> in-flight task id
        self._started_at: Dict[str, float] = {}  # task id -> start time
        self._requeued: set = set()  # ids given back after a lost child
        self._lock = threading.Lock()
        self._stop = threading.Event()
        for _ in range(concurrency):
            self._spawn_child()
        self._threads = [
            threading.Thread(target=target, daemon=True)
            for target in (self._dispatch_loop, self._event_pump,
                           self._monitor_loop)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------
    def _spawn_child(self):
        inbox = self._ctx.Queue()
        # Per-child event channel: killing this child can only tear
        # THIS pipe; siblings keep delivering events. A raw one-way
        # Pipe (not SimpleQueue) with the parent's write end CLOSED
        # makes a dead child observable as EOFError on recv — a
        # SimpleQueue keeps a parent-side writer open forever, so a
        # recv racing a SIGKILL mid-put would block instead of raise.
        event_r, event_w = self._ctx.Pipe(duplex=False)
        p = self._ctx.Process(
            target=child_main,
            args=(
                inbox, event_w, self.revoked,
                self._tasks_module, self._max_tasks,
            ),
            daemon=True,
        )
        p.start()
        event_w.close()  # child holds the only writer now
        with self._lock:
            self._children[p.pid] = _Child(
                p, inbox, event_r, threading.Lock()
            )

    def submit(self, rec) -> None:
        self._pending.put(rec)

    def revoke(self, task_id: str, terminate: bool = False) -> None:
        self.revoked[task_id] = "revoke"
        if terminate:
            self._kill_task(task_id, final_state="REVOKED",
                            reason="revoked (terminate=True)")

    def alive_workers(self) -> int:
        with self._lock:
            return sum(1 for c in self._children.values() if c.proc.is_alive())

    def shutdown(self):
        """Stop the pool and leave no child behind: the pool's threads
        end first (a respawn in flight finishes, and none starts after),
        then each child gets 2 s to leave (a CUDA context takes a while
        to tear down) before SIGKILL, and every child is reaped."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
        with self._lock:
            children = list(self._children.values())
        for c in children:
            try:
                c.inbox.put(None)
            except Exception:
                pass
        for c in children:
            _reap(c.proc, grace=2)
        self._manager.shutdown()

    # ------------------------------------------------------------------
    def _dispatch_loop(self):
        """Hand each pending record to :meth:`_assign`, waiting while no
        child has room for it."""
        while not self._stop.is_set():
            try:
                rec = self._pending.get(timeout=0.2)
            except _queue.Empty:
                continue
            while not self._stop.is_set() and not self._assign(rec):
                time.sleep(0.05)

    def _assign(self, rec) -> bool:
        """Put ``rec`` into the inbox of a live child that holds no task
        and has been sent fewer than ``max_tasks_per_child`` payloads,
        recording the assignment BEFORE the payload enters the inbox —
        worker-lost attribution never depends on the child flushing an
        event. A child reads no payload past its limit (it recycles), so
        none is sent to it. False when no child has room; True when
        ``rec`` went out or was revoked while queued."""
        if rec.cancel_event.is_set():
            return True
        with self._lock:
            idle = next(
                (
                    pid
                    for pid, c in self._children.items()
                    if c.proc.is_alive() and pid not in self._assigned
                    and (self._max_tasks <= 0 or c.sent < self._max_tasks)
                ),
                None,
            )
            if idle is None:
                return False
            self._assigned[idle] = rec.id
            child = self._children[idle]
            child.sent += 1
        child.inbox.put(
            {
                "id": rec.id,
                "name": rec.name,
                "args": list(rec.args),
                "kwargs": rec.kwargs,
                "queue": rec.queue,
            }
        )
        return True

    def _finish(self, rec, state, result, tb):
        q = self._backend
        rec.state = state
        rec.result = result
        rec.traceback = tb or ""
        rec.finished_at = time.time()
        key = {"SUCCESS": "completed", "FAILURE": "failed",
               "REVOKED": "revoked"}[state]
        q._stats[key] += 1
        self._started_at.pop(rec.id, None)
        self._requeued.discard(rec.id)
        self.revoked.pop(rec.id, None)
        if state == "FAILURE":
            for hook in q.on_failure:
                _safe(hook, rec, RuntimeError(str(result)))
        for hook in q.on_postrun:
            _safe(hook, rec)

    def _event_pump(self):
        while not self._stop.is_set():
            with self._lock:
                children = list(self._children.values())
            got = False
            for child in children:
                got |= self._drain_channel(child)
            if not got:
                time.sleep(0.02)

    def _drain_channel(self, child) -> bool:
        """Read every ready event off one child's pipe. The per-child
        lock keeps this single-consumer (pump vs monitor/kill). A dead
        child's pipe raises EOFError on recv (its only writer closed);
        a frame a SIGKILL tore mid-send raises on recv/unpickle — stop
        reading, only that child's remaining events are lost."""
        got = False
        with child.drain_lock:
            try:
                while child.event_r.poll(0):
                    self._handle_event(child.event_r.recv())
                    got = True
            except Exception:
                pass
        return got

    def _handle_event(self, event):
        q = self._backend
        kind = event[0]
        if kind == "started":
            _, tid, pid = event
            rec = q.records.get(tid)
            self._started_at[tid] = time.time()
            if rec is not None:
                rec.state = "STARTED"
                rec.started_at = time.time()
                for hook in q.on_prerun:
                    _safe(hook, rec)
        elif kind == "state":
            _, tid, state, meta = event
            rec = q.records.get(tid)
            if rec is not None and rec.state not in (
                "SUCCESS", "FAILURE", "REVOKED"
            ):
                rec.state = state
                rec.info = meta
        elif kind == "done":
            _, tid, state, result, tb = event
            with self._lock:
                for pid, assigned in list(self._assigned.items()):
                    if assigned == tid:
                        del self._assigned[pid]
            rec = q.records.get(tid)
            if rec is not None and rec.state not in (
                "SUCCESS", "FAILURE", "REVOKED"
            ):
                self._finish(rec, state, result, tb)
        elif kind == "recycled":
            _, pid, _ = event
            self._respawn(pid)

    def _respawn(self, pid: int):
        """Replace child ``pid``, which recycled or was killed. It holds
        no task by then: a recycling child was sent no payload past its
        last "done", and a kill releases its task first."""
        with self._lock:
            c = self._children.pop(pid, None)
            self._assigned.pop(pid, None)
        if c is None:
            return  # another path (monitor/kill) already handled this pid
        _reap(c.proc, grace=5)
        if not self._stop.is_set():
            self._spawn_child()

    def _kill_task(self, task_id: str, final_state: str, reason: str):
        """SIGKILL whichever child is running ``task_id`` (billiard hard-
        limit semantics), finalize the record, respawn a fresh child."""
        with self._lock:
            pid = next(
                (p for p, t in self._assigned.items() if t == task_id), None
            )
            child = self._children.get(pid) if pid else None
            if pid is not None:
                self._assigned.pop(pid, None)
        if child is not None and child.proc.is_alive():
            child.proc.kill()
            child.proc.join(timeout=5)
            logger.warning("killed worker %s: %s", pid, reason)
        if child is not None:
            # A "done" may have raced the kill; deliver what survived.
            self._drain_channel(child)
        rec = self._backend.records.get(task_id)
        if rec is not None and rec.state not in (
            "SUCCESS", "FAILURE", "REVOKED"
        ):
            self._finish(rec, final_state, reason, "")
        if pid is not None:
            self._respawn(pid)

    def _monitor_loop(self):
        q = self._backend
        while not self._stop.is_set():
            now = time.time()
            for tid, t0 in list(self._started_at.items()):
                elapsed = now - t0
                if elapsed > q.soft_time_limit:
                    self.revoked.setdefault(tid, "soft")  # cooperative
                if elapsed > q.hard_time_limit:
                    self._kill_task(
                        tid, final_state="FAILURE",
                        reason="hard time limit exceeded",
                    )
            self._reap_dead()
            time.sleep(0.2)

    def _reap_dead(self):
        """Worker-lost detection: release every dead child and spawn its
        replacement. A task the child had started is marked FAILURE
        ("worker lost"); one it never started goes back on ``_pending``
        the first time, and is marked FAILURE the second."""
        q = self._backend
        with self._lock:
            dead = [
                (pid, c)
                for pid, c in self._children.items()
                if not c.proc.is_alive()
            ]
        for pid, c in dead:
            # Deliver any events flushed before death ("done" etc.)
            # so a completed task isn't misreported as worker-lost.
            self._drain_channel(c)
            with self._lock:
                if self._children.pop(pid, None) is None:
                    continue  # already handled by recycle/kill paths
                tid = self._assigned.pop(pid, None)
            rec = q.records.get(tid) if tid else None
            if rec is not None and rec.state not in (
                "SUCCESS", "FAILURE", "REVOKED"
            ):
                if tid not in self._started_at and tid not in self._requeued:
                    self._requeued.add(tid)
                    self._pending.put(rec)
                else:
                    self._finish(
                        rec, "FAILURE",
                        f"worker lost (pid {pid} exit "
                        f"{c.proc.exitcode})", "",
                    )
            if not self._stop.is_set():
                self._spawn_child()


def _reap(proc, grace: float) -> None:
    """Join ``proc``; SIGKILL it if it has not left within ``grace``
    seconds, and join it again."""
    proc.join(timeout=grace)
    if proc.is_alive():
        proc.kill()
        proc.join(timeout=30)


def _safe(fn, *args):
    try:
        fn(*args)
    except Exception:  # hooks must never kill the pool
        logger.exception("task signal hook failed")
