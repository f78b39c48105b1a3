"""The API side of a brokered fleet, run as a process by
``tests/test_torch_fleet.py``: the port's app on 127.0.0.1 with its
settings from the environment (``CELERY_BROKER_URL`` among them). Its own
queue drains nothing (concurrency 0), so every job it enqueues runs in a
``worker`` process. Prints ``PORT <n>`` once it serves; stop it with a signal.

    python tests/torch_fleet_api.py
"""
from vtd_tpu_torch.serve.app import create_app
from vtd_tpu_torch.serve.http import Server
from vtd_tpu_torch.serve.queue import task_queue


class NoLimit:  # polling must not meet the processing rate limit
    def incr_window(self, key, window_s):
        return 0


def main():
    if task_queue.broker is None:
        raise SystemExit("CELERY_BROKER_URL names no shared broker")
    task_queue.concurrency = 0
    server = Server(create_app(start_worker=False,
                               rate_limit_store=NoLimit()),
                    "127.0.0.1", 0)
    server.start_background()  # the startup hooks create the tables
    print(f"PORT {server.port}", flush=True)
    server.thread.join()


if __name__ == "__main__":
    main()
