"""``python -m vtd_tpu_torch worker`` with a test module's tasks registered
on its queue too, for the port's fleet tests:

    python tests/torch_worker.py <tasks module> [worker arguments]

The module's task objects (attributes with a ``name`` and an ``fn``, as a
process-pool child finds them) are added after the service's own tasks,
so a module may stand in for one of them by name.
"""
import sys

from vtd_tpu_torch.__main__ import main
from vtd_tpu_torch.serve import tasks  # noqa: F401  the service's tasks first
from vtd_tpu_torch.serve.procworker import task_registry
from vtd_tpu_torch.serve.queue import task_queue

if __name__ == "__main__":
    task_queue.tasks.update(task_registry(sys.argv[1]))
    sys.exit(main(["worker", *sys.argv[2:]]))
