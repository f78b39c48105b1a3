"""Tasks for the port's fleet tests, importable by process-pool children
and by ``python tests/torch_worker.py torch_proc_tasks`` workers (both
find them as module attributes with a ``name`` and an ``fn``; spawn
re-imports this module by name, so the tasks live in a real module).

The rendezvous tasks take the directory the test shares with its worker
processes and wait on files in it, with deadlines of minutes, never on
fixed sleeps.
"""
import os
import time

from vtd_tpu_torch.serve.queue import TaskQueue

registry_queue = TaskQueue()
RENDEZVOUS_S = 240.0


def wait_file(path, deadline_s=RENDEZVOUS_S):
    deadline = time.time() + deadline_s
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"rendezvous timeout on {path}")
        time.sleep(0.02)


def mark_run(root, i):
    """One file per run of task ``i`` (O_EXCL: a second run of the same
    task id in any process fails loudly instead of overwriting)."""
    fd = os.open(os.path.join(root, f"ran_{i}_{os.getpid()}"),
                 os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    os.close(fd)


@registry_queue.task(name="add")
def add(self, a, b):
    return a + b


@registry_queue.task(name="sleepy")
def sleepy(self, seconds):
    """Cooperative task: polls is_revoked (soft-limit / revoke path)."""
    t0 = time.time()
    while time.time() - t0 < seconds:
        time.sleep(0.05)
        if self.is_revoked():
            raise InterruptedError("cancelled")
    return "done"


@registry_queue.task(name="hang")
def hang(self, seconds):
    """Uncooperative task: never polls is_revoked (hard-limit path)."""
    time.sleep(seconds)
    return "finished"


@registry_queue.task(name="whoami")
def whoami(self):
    return os.getpid()


@registry_queue.task(name="crash")
def crash(self):
    os._exit(9)


@registry_queue.task(name="hold")
def hold(self, root, i):
    """Publish PROGRESS, tell the producer (a file) and hold the worker's
    slot until the producer's ``go`` file appears."""
    mark_run(root, i)
    self.update_state("PROGRESS", {"i": i, "pid": os.getpid()})
    open(os.path.join(root, f"holding_{i}"), "w").close()
    wait_file(os.path.join(root, "go"))
    return {"i": i, "pid": os.getpid()}


@registry_queue.task(name="mark")
def mark(self, root, i):
    mark_run(root, i)
    return {"i": i, "pid": os.getpid()}
