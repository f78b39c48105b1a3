"""The port's serving fleet across processes, on the CPU.

- Two ``worker --device cpu --concurrency 1`` processes (the port's
  command, started through ``tests/torch_worker.py``) drain one
  ``file://`` queue and one ``tcp://`` queue: every task runs exactly
  once, both workers hold a task at once, PROGRESS published by a worker
  is read by the producer, and a pending task the producer revokes never
  runs. Rendezvous go through files the test and the workers share,
  each wait with a deadline of minutes.
- The service over a broker: ``brokerd`` and one ``worker`` as processes,
  the port's app as a third process that drains nothing; a job posted
  over HTTP with the port's ``APIClient`` completes in the worker, and
  its detections equal the thread worker's on the same clip.
- The commands: ``worker`` refuses to run without CUDA, with the
  multi-process variables set, and on an in-process broker; ``brokerd
  --port 0`` starts and answers a ping.

Every process is started with its own log file and stopped (SIGINT, then
SIGKILL after a deadline) in a ``finally``.
"""
import os
import re
import signal
import subprocess
import sys
import time
from unittest import mock

import pytest

import torch_proc_tasks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
DEADLINE_S = 240.0
# the service's job against the thread worker's (test_torch_serve.py's
# serving tolerances)
BOX_TOL_PX = 1
SCORE_TOL = 1e-3


def child_env(**extra):
    path = os.pathsep.join(
        p for p in (REPO, TESTS, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="2",
               no_proxy="127.0.0.1,localhost", NO_PROXY="127.0.0.1,localhost")
    env.update(extra)
    return env


class Fleet:
    """Processes of one test, each logging to its own file."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.procs = []

    def start(self, name, args, cwd=None, **env):
        log = os.path.join(self.tmp, f"{name}.log")
        with open(log, "wb") as fh:
            proc = subprocess.Popen(
                [sys.executable, *args], cwd=cwd or self.tmp,
                env=child_env(**env), stdout=fh, stderr=subprocess.STDOUT)
        self.procs.append((name, proc, log))
        return proc

    def worker(self, name, broker, tasks_module, **env):
        """``python -m vtd_tpu_torch worker`` with ``tasks_module``'s
        tasks registered too (``tests/torch_worker.py``)."""
        return self.start(name, [
            os.path.join(TESTS, "torch_worker.py"), tasks_module,
            "--device", "cpu", "--concurrency", "1", "--broker", broker],
            **env)

    def logs(self):
        return {name: open(log, errors="replace").read()[-3000:]
                for name, _, log in self.procs}

    def wait_line(self, name, pattern):
        """The first match of ``pattern`` in ``name``'s log."""
        proc, log = next((p, lg) for n, p, lg in self.procs if n == name)
        deadline = time.time() + DEADLINE_S
        while True:
            m = re.search(pattern, open(log, errors="replace").read())
            if m:
                return m
            assert proc.poll() is None, (name, self.logs())
            assert time.time() < deadline, (name, self.logs())
            time.sleep(0.05)

    def alive(self):
        dead = [n for n, p, _ in self.procs if p.poll() is not None]
        assert not dead, (dead, self.logs())

    def stop(self):
        for _, proc, _ in self.procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for _, proc, _ in self.procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        assert all(p.poll() is not None for _, p, _ in self.procs)


def wait_for(pred, fleet, what):
    deadline = time.time() + DEADLINE_S
    while not pred():
        fleet.alive()
        assert time.time() < deadline, (what, fleet.logs())
        time.sleep(0.05)


@pytest.fixture
def fleet(tmp_path):
    f = Fleet(str(tmp_path))
    try:
        yield f
    finally:
        f.stop()


def runs(root, i):
    return [n for n in os.listdir(root) if n.startswith(f"ran_{i}_")]


@pytest.mark.parametrize("scheme", ["file", "tcp"])
def test_two_workers_drain_one_queue(scheme, tmp_path, fleet):
    from vtd_tpu_torch.serve.broker import FileBroker
    from vtd_tpu_torch.serve.brokerd import BrokerServer, TcpBroker
    from vtd_tpu_torch.serve.queue import TaskQueue

    root = str(tmp_path / "shared")
    os.makedirs(root)
    srv = None
    if scheme == "file":
        url = f"file://{tmp_path}/queue"
        broker = FileBroker(str(tmp_path / "queue"), "producer")
    else:
        srv = BrokerServer("127.0.0.1", 0, reap_interval=3600.0)
        srv.start()
        url = f"tcp://{srv.host}:{srv.port}"
        broker = TcpBroker(srv.host, srv.port, worker_id="producer")
    producer = TaskQueue(concurrency=0, broker=broker)
    for t in (torch_proc_tasks.hold, torch_proc_tasks.mark):
        producer.task(name=t.name)(t.fn)  # registration only
    try:
        # both workers' single slots take a hold each; the third waits
        holds = [producer.tasks["hold"].apply_async(
            args=(root, i), task_id=f"hold{i}") for i in range(3)]
        marks = [producer.tasks["mark"].apply_async(
            args=(root, 10 + i), task_id=f"mark{i}") for i in range(8)]
        for k in range(2):
            fleet.worker(f"w{k}", url, "torch_proc_tasks")
        wait_for(lambda: sum(os.path.exists(os.path.join(root, f"holding_{i}"))
                             for i in range(3)) == 2, fleet, "two holds")
        held = [r for r in holds if r.state == "PROGRESS"]
        assert len(held) == 2, [r.state for r in holds]
        assert {r.info["i"] for r in held} == {
            i for i in range(3) if os.path.exists(
                os.path.join(root, f"holding_{i}"))}
        assert len({r.info["pid"] for r in held}) == 2  # both workers
        (pending,) = [r for r in holds if r not in held]
        assert pending.state == "PENDING"
        assert producer.revoke(pending.id)
        assert broker.get_state(pending.id)["state"] == "REVOKED"
        open(os.path.join(root, "go"), "w").close()
        done = held + marks
        wait_for(lambda: all(r.ready() for r in done), fleet, "results")
        assert all(r.successful() for r in done), [
            (r.id, r.state, r.result) for r in done]
        assert {r.result["pid"] for r in held} == {
            r.info["pid"] for r in held}
        # every task ran once, the revoked one never
        for r in done:
            assert len(runs(root, r.result["i"])) == 1, r.id
        assert runs(root, int(pending.id[len("hold"):])) == []
        # the revoked task is dropped once a worker reaches it
        wait_for(lambda: broker.pending_count() == 0, fleet, "drained")
        assert pending.state == "REVOKED"
    finally:
        fleet.stop()
        producer.shutdown()
        if srv is not None:
            srv.shutdown()


def _same_detections(a, b):
    fa, fb = a["results"], b["results"]
    assert [f["frame_number"] for f in fa] == [f["frame_number"] for f in fb]
    for x, y in zip(fa, fb):
        dx = sorted(x["detections"], key=lambda d: d["text"])
        dy = sorted(y["detections"], key=lambda d: d["text"])
        assert [d["text"] for d in dx] == [d["text"] for d in dy]
        for p, q in zip(dx, dy):
            assert max(abs(u - v) for u, v in zip(p["bbox"], q["bbox"])) \
                <= BOX_TOL_PX
            for k in ("detection_confidence", "recognition_confidence"):
                assert abs(p[k] - q[k]) <= SCORE_TOL, (k, p[k], q[k])


def test_service_over_tcp_broker_with_worker_process(tmp_path, fleet,
                                                     monkeypatch):
    """brokerd, one worker and the API as three processes; the job is
    posted and read back with the port's APIClient."""
    from test_torch_serve import write_clip
    from vtd_tpu_torch.frontend.client import APIClient
    from vtd_tpu_torch.serve import tasks

    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
    clip = write_clip(str(tmp_path / "clip.mp4"))
    env = {"DATABASE_URL": f"sqlite:///{tmp_path}/vtd.db",
           "TEMP_DIR": str(tmp_path / "temp"),
           "OUTPUT_DIR": str(tmp_path / "out"),
           "MODEL_PATH": str(tmp_path / "models")}
    fleet.start("brokerd", ["-m", "vtd_tpu_torch", "brokerd", "--host",
                            "127.0.0.1", "--port", "0"])
    port = fleet.wait_line("brokerd", r"listening on 127\.0\.0\.1:(\d+)")[1]
    url = f"tcp://127.0.0.1:{port}"
    fleet.worker("worker", url, "torch_video_tasks", **env)
    fleet.start("api", [os.path.join(TESTS, "torch_fleet_api.py")],
                CELERY_BROKER_URL=url, **env)
    api_port = fleet.wait_line("api", r"PORT (\d+)")[1]

    client = APIClient(f"http://127.0.0.1:{api_port}", timeout=60.0)
    assert client.register("fleet@example.com", "fleet", "pw")
    assert client.login("fleet", "pw")
    video = client.upload_video("clip.mp4", open(clip, "rb").read())
    assert video is not None
    job = client.start_processing(video["id"], use_transformer=False)
    assert job is not None and job["status"] == "pending", job
    status = client.wait_for_job(job["id"], timeout=DEADLINE_S, poll=0.1)
    assert status is not None, fleet.logs()
    assert status["status"] == "completed", (status, fleet.logs())
    served = client.get_results(video["id"])
    fleet.alive()

    import torch_video_tasks

    tasks.configure_pipeline(**torch_video_tasks.PIPE)
    try:
        _, row = torch_video_tasks.run_on_thread_worker(
            clip, {"confidence_threshold": 0.5, "use_transformer": False})
    finally:
        tasks.configure_pipeline()
    assert row["status"] == "completed"
    _same_detections(served["results"], row["result_data"])
    assert served["summary"]["total_detections"] == \
        row["result_data"]["summary"]["total_detections"] > 0


@pytest.mark.parametrize("argv,env,message", [
    (["worker"], {}, "CUDA is not available"),
    # a world of one: the worker joins it (gloo on the CPU), then goes on
    # to its broker, which is refused here
    (["worker", "--device", "cpu"],
     {"VTD_COORDINATOR_ADDRESS": "127.0.0.1:{port}",
      "VTD_NUM_PROCESSES": "1"}, "requires a non-local broker"),
    (["worker", "--device", "cpu", "--broker", "local://"], {},
     "requires a non-local broker"),
], ids=["no_cuda", "coordinator", "local_broker"])
def test_worker_refuses(argv, env, message, capsys, monkeypatch):
    import torch

    from vtd_tpu_torch.__main__ import main
    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.core.mesh import free_port

    if "--device" not in argv and torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    monkeypatch.setattr(settings, "device", settings.device)
    monkeypatch.setattr(settings, "celery_broker_url",
                        settings.celery_broker_url)
    before = dict(os.environ)
    # the whole environment comes back: ``worker`` writes DEVICE for the
    # children it would spawn, and the later tests' children inherit it
    try:
        with mock.patch.dict(os.environ):
            for var in ("VTD_COORDINATOR_ADDRESS", "VTD_NUM_PROCESSES",
                        "VTD_PROCESS_ID", "DEVICE"):
                os.environ.pop(var, None)
            os.environ.update({k: v.format(port=free_port())
                               for k, v in env.items()})
            assert main(argv) == 2
            joined = torch.distributed.is_initialized()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    out = capsys.readouterr()
    assert message in out.err
    assert joined == bool(env)
    assert ("worker: rank 0 of 1 (gloo)" in out.out) == bool(env)
    assert dict(os.environ) == before


def test_brokerd_command_answers_ping(tmp_path, fleet):
    from vtd_tpu_torch.serve.brokerd import TcpBroker

    fleet.start("brokerd", ["-m", "vtd_tpu_torch", "brokerd", "--host",
                            "127.0.0.1", "--port", "0", "--token", "t0k"])
    port = int(fleet.wait_line("brokerd",
                               r"listening on 127\.0\.0\.1:(\d+)")[1])
    assert TcpBroker("127.0.0.1", port, token="t0k").ping()
    with pytest.raises(RuntimeError, match="auth"):
        TcpBroker("127.0.0.1", port, token="wrong").ping()
    fleet.stop()
    (_, proc, _), = fleet.procs
    assert proc.returncode is not None
