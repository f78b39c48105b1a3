"""The port's process pool (``TaskQueue(worker_kind="process")``), with
the cases of ``tests/test_procworker.py``: tasks run in spawned children;
the hard limit SIGKILLs an uncooperative task and a fresh child takes
its place; the soft limit cancels a cooperative one; ``revoke(terminate=
True)`` kills a running task; ``max_tasks_per_child`` recycles a child
(a new pid); a crashing child marks its task FAILURE ("worker lost").
Then a child runs the service's real ``process_video_task`` on a clip on
the CPU and returns what the thread worker returns for the same job.

Every wait has a deadline; a spawn imports torch, a few seconds here.
"""
import time

import pytest
import torch

import torch_proc_tasks

torch.set_num_threads(2)

DEADLINE_S = 180.0


def make_queue(**kw):
    from vtd_tpu_torch.serve.queue import TaskQueue

    defaults = dict(
        worker_kind="process", tasks_module="torch_proc_tasks",
        concurrency=1, max_tasks_per_child=10,
    )
    defaults.update(kw)
    q = TaskQueue(**defaults)
    # parent-side registration mirrors the child's module registry
    for t in (torch_proc_tasks.add, torch_proc_tasks.sleepy,
              torch_proc_tasks.hang, torch_proc_tasks.whoami,
              torch_proc_tasks.crash):
        q.task(name=t.name)(t.fn)
    return q


def wait_for(pred, timeout=DEADLINE_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture
def q():
    queue = make_queue()
    yield queue
    queue.shutdown()


def test_process_worker_runs_tasks(q):
    res = q.tasks["add"].delay(2, 3)
    assert res.get(timeout=DEADLINE_S) == 5
    assert q.stats()["completed"] == 1
    assert q.stats()["workers"] == 1


def test_hard_limit_kills_uncooperative_task():
    q = make_queue(soft_time_limit=0.5, hard_time_limit=1.2)
    try:
        res = q.tasks["hang"].delay(600)
        assert wait_for(lambda: res.state == "FAILURE"), res.state
        assert "hard time limit" in str(res.result)
        # a fresh child replaces the killed one, and the pool still works
        assert wait_for(lambda: q._pool.alive_workers() >= 1)
        assert q.tasks["add"].delay(1, 1).get(timeout=DEADLINE_S) == 2
    finally:
        q.shutdown()


def test_soft_limit_cancels_cooperative_task():
    q = make_queue(soft_time_limit=0.4, hard_time_limit=600.0)
    try:
        res = q.tasks["sleepy"].delay(600)
        # the task sees the revocation flag and unwinds -> REVOKED
        assert wait_for(lambda: res.state == "REVOKED"), res.state
    finally:
        q.shutdown()


def test_revoke_terminate_kills_running_task(q):
    res = q.tasks["hang"].delay(600)
    assert wait_for(lambda: res.state == "STARTED"), res.state
    pid = next(iter(q._pool._assigned))
    q.revoke(res.id, terminate=True)
    assert wait_for(lambda: res.state == "REVOKED"), res.state
    assert "terminate=True" in str(res.result)
    # the killed child is gone; its replacement runs the next task
    assert q.tasks["whoami"].delay().get(timeout=DEADLINE_S) != pid


def test_max_tasks_per_child_recycles():
    q = make_queue(max_tasks_per_child=2)
    try:
        pids = [q.tasks["whoami"].delay().get(timeout=DEADLINE_S)
                for _ in range(4)]
        assert pids[0] == pids[1] and pids[2] == pids[3], pids
        assert pids[1] != pids[2], pids
    finally:
        q.shutdown()


def test_worker_lost_marks_failure(q):
    res = q.tasks["crash"].delay()
    assert wait_for(lambda: res.state == "FAILURE"), res.state
    assert "worker lost" in str(res.result)
    assert q.tasks["add"].delay(3, 4).get(timeout=DEADLINE_S) == 7


def test_child_runs_the_video_task_like_the_thread_worker(tmp_path,
                                                          monkeypatch):
    """The service's own task in a pool child (its pipeline configured by
    ``tests/torch_video_tasks.py`` at import, its settings and a file
    database from the environment) and on the thread worker: equal
    returns, equal job rows' detections."""
    from test_torch_serve import write_clip
    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.serve import tasks
    from vtd_tpu_torch.serve.db import ProcessingJobCRUD, database
    from vtd_tpu_torch.serve.queue import TaskQueue

    env = {"DATABASE_URL": f"sqlite:///{tmp_path}/vtd.db",
           "TEMP_DIR": str(tmp_path / "temp"),
           "OUTPUT_DIR": str(tmp_path / "out"),
           "MODEL_PATH": str(tmp_path / "models"), "DEVICE": "cpu"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
        monkeypatch.setattr(settings, k.lower(), v)
    monkeypatch.setattr(database, "_default_db", None)
    database.init_db()
    db = database.get_database()
    clip = write_clip(str(tmp_path / "clip.mp4"))
    config = {"use_transformer": False, "confidence_threshold": 0.5}

    import torch_video_tasks

    video_id = torch_video_tasks.add_video_job(db, clip, "process-job")
    tasks.configure_pipeline(**torch_video_tasks.PIPE)  # the same sizes
    q = TaskQueue(worker_kind="process", concurrency=1,
                  tasks_module="torch_video_tasks")
    q.task(name="process_video_task")(
        torch_video_tasks.process_video_task.fn)
    try:
        res = q.submit(q.tasks["process_video_task"], (video_id, config),
                       {}, task_id="process-job")
        assert wait_for(res.ready), res.state
        assert res.state == "SUCCESS", (res.result, res.traceback)
        assert q.stats()["workers"] == 1
        ret_p = res.result
        row_p = ProcessingJobCRUD.get_by_task_id(db, "process-job")
        ret_t, row_t = torch_video_tasks.run_on_thread_worker(clip, config)
    finally:
        q.shutdown()
        tasks.configure_pipeline()
    assert row_p["status"] == row_t["status"] == "completed"
    for ret in (ret_p, ret_t):
        ret["results"].pop("processing_time_seconds")
        ret["results"].pop("fps_processed", None)
    assert ret_p == ret_t
    assert ret_t["total_detections"] > 0
    frames_p = row_p["result_data"]["results"]
    frames_t = row_t["result_data"]["results"]
    assert len(frames_p) == len(frames_t) == 20
    assert frames_p == frames_t


# ---------------------------------------------------------------------------
# The pool's parent side driven by stand-in children, no processes: the
# test calls the handlers in the order it wants, so each window is held
# open without a sleep.
# ---------------------------------------------------------------------------
class _StandInProc:
    def __init__(self, pid):
        self.pid = pid
        self.alive = True
        self.exitcode = None

    def start(self):
        pass

    def is_alive(self):
        return self.alive

    def join(self, timeout=None):
        self.alive = False
        self.exitcode = 0 if self.exitcode is None else self.exitcode

    def kill(self):
        self.alive, self.exitcode = False, -9


class _CountingInbox:
    def __init__(self):
        import queue

        self._q = queue.Queue()
        self.received = 0

    def put(self, payload):
        if payload is not None:
            self.received += 1
        self._q.put(payload)

    def get_nowait(self):
        return self._q.get_nowait()


class _StandInCtx:
    """What the pool asks of ``multiprocessing.get_context("spawn")``:
    queues, pipes and processes that are plain objects here."""

    def __init__(self):
        self.procs = []
        self.inboxes = []

    def Manager(self):
        import types

        return types.SimpleNamespace(dict=dict, shutdown=lambda: None)

    def Queue(self):
        self.inboxes.append(_CountingInbox())
        return self.inboxes[-1]

    def Pipe(self, duplex=False):
        import types

        reader = types.SimpleNamespace(poll=lambda timeout=0: False)
        return reader, types.SimpleNamespace(close=lambda: None)

    def Process(self, target, args, daemon):
        self.procs.append(_StandInProc(10_000 + len(self.procs)))
        return self.procs[-1]


def _stand_in_pool(monkeypatch, max_tasks_per_child):
    """A pool with one stand-in child and its loops not running, over a
    real queue's records; returns (pool, ctx, records)."""
    from vtd_tpu_torch.serve import procworker
    from vtd_tpu_torch.serve.queue import TaskQueue, TaskRecord

    ctx = _StandInCtx()
    monkeypatch.setattr(procworker.mp, "get_context", lambda kind: ctx)
    for loop in ("_dispatch_loop", "_event_pump", "_monitor_loop"):
        monkeypatch.setattr(procworker.ProcessWorkerPool, loop,
                            lambda self: None)
    q = TaskQueue(worker_kind="process")
    pool = procworker.ProcessWorkerPool(
        q, concurrency=1, max_tasks_per_child=max_tasks_per_child)
    for t in pool._threads:
        t.join(timeout=10)
    records = [TaskRecord(id=f"task-{i}", name="add", args=(i, 1),
                          kwargs={}) for i in range(5)]
    for rec in records:
        q.records[rec.id] = rec
        pool.submit(rec)
    return pool, ctx, records


class _Dispatcher:
    """One pass of the pool's dispatch loop per call: it holds a record
    taken off the pending queue until a child has room for it."""

    def __init__(self, pool):
        self.pool = pool
        self.held = None

    def __call__(self):
        import queue

        while True:
            if self.held is None:
                try:
                    self.held = self.pool._pending.get_nowait()
                except queue.Empty:
                    return
            if not self.pool._assign(self.held):
                return
            self.held = None


def _live_child(pool):
    (pid, child), = [(p, c) for p, c in pool._children.items()
                     if c.proc.is_alive()]
    return pid, child


def test_no_task_lost_between_a_childs_last_done_and_its_recycle(
        monkeypatch):
    """A child sends "done" for its ``max_tasks_per_child``-th task, the
    dispatcher runs, and only then does the child's "recycled" arrive:
    no payload goes to that child, and every task completes exactly
    once in the children that follow."""
    limit = 2
    pool, ctx, records = _stand_in_pool(monkeypatch, limit)
    dispatch = _Dispatcher(pool)
    ran = []
    done_in_child = {}
    for _ in range(4 * len(records)):
        dispatch()
        pid, child = _live_child(pool)
        try:
            payload = child.inbox.get_nowait()
        except Exception:
            break
        pool._handle_event(("started", payload["id"], pid))
        pool._handle_event(("done", payload["id"], "SUCCESS", sum(
            payload["args"]), ""))
        ran.append(payload["id"])
        done_in_child[pid] = done_in_child.get(pid, 0) + 1
        if done_in_child[pid] == limit:
            dispatch()  # the window: after "done", before "recycled"
            pool._handle_event(("recycled", pid, None))
    assert sorted(ran) == [r.id for r in records]
    assert [r.state for r in records] == ["SUCCESS"] * len(records)
    assert [r.result for r in records] == [i + 1 for i in range(5)]
    assert max(inbox.received for inbox in ctx.inboxes) <= limit
    assert len(ctx.procs) == 3  # two recycles
    pool.shutdown()


@pytest.mark.parametrize("started", [False, True])
def test_a_lost_child_requeues_only_a_task_it_never_started(
        monkeypatch, started):
    """A child that dies holding a task it never sent "started" for
    gives the task back, and a later child runs it; a task that did
    start is marked FAILURE ("worker lost"), as in the reference, and
    does not run again."""
    pool, ctx, records = _stand_in_pool(monkeypatch, 10)
    dispatch = _Dispatcher(pool)
    dispatch()
    pid, child = _live_child(pool)
    assert child.inbox.get_nowait()["id"] == "task-0"
    if started:
        pool._handle_event(("started", "task-0", pid))
    child.proc.kill()
    pool._reap_dead()
    new_pid, new_child = _live_child(pool)
    assert new_pid != pid
    ran = []
    for _ in range(len(records)):
        dispatch()
        payload = new_child.inbox.get_nowait()
        pool._handle_event(("started", payload["id"], new_pid))
        pool._handle_event(("done", payload["id"], "SUCCESS", 0, ""))
        ran.append(payload["id"])
        if len(ran) == len(records) - started:
            break
    assert sorted(ran) == [r.id for r in records[started:]]
    want = ["FAILURE"] * started + ["SUCCESS"] * (len(records) - started)
    assert [r.state for r in records] == want
    if started:
        assert "worker lost" in str(records[0].result)
    pool.shutdown()


def test_a_task_no_child_starts_fails_after_one_requeue(monkeypatch):
    """Every child dies before it sends "started" (a task module that
    does not import, a card that does not start): each task goes back
    on the pending queue once, reaches a second child, and then ends
    FAILURE ("worker lost") rather than circling the pool."""
    pool, ctx, records = _stand_in_pool(monkeypatch, 10)
    dispatch = _Dispatcher(pool)
    sent = []
    for _ in range(4 * len(records)):
        dispatch()
        pid, child = _live_child(pool)
        try:
            sent.append(child.inbox.get_nowait()["id"])
        except Exception:
            break
        child.proc.kill()
        pool._reap_dead()
    assert sorted(sent) == sorted(2 * [r.id for r in records])
    assert [r.state for r in records] == ["FAILURE"] * len(records)
    assert all("worker lost" in str(r.result) for r in records)
    assert len(ctx.procs) == 1 + 2 * len(records)
    pool.shutdown()
