"""The port's brokers against ``vtd_tpu``'s, in one process.

A queue directory and the brokerd wire protocol are contracts between
hosts, so each side must read what the other writes:

- ``FileBroker``: one package enqueues and the other claims, on the same
  directory, in both directions; states, revoke markers, heartbeats,
  ``requeue_stale`` and the TTL garbage collection give equal answers
  and equal directory listings when the same operations run on both.
- ``TcpBroker`` / ``BrokerServer``: the port's client against the
  reference's daemon and the reference's client against the port's
  daemon, both daemons in a thread of this process: ping, round trip,
  exclusive claim, FIFO with a requeue keeping its place, revoke while
  pending, token auth, and ``stats()`` equal to the other daemon's after
  the same operations.

Also here: the port's two departures from the reference (a claim
without a heartbeat yet is not requeued at once; a producer does not
heartbeat a claim it only reads), the settings' broker URLs and the
health probe of each scheme.
"""
import asyncio
import os
import time

import pytest

import vtd_tpu.serve.broker as ref_file
import vtd_tpu.serve.brokerd as ref_tcp
import vtd_tpu_torch.serve.broker as port_file
import vtd_tpu_torch.serve.brokerd as port_tcp

SIDES = {"ref": (ref_file, ref_tcp), "port": (port_file, port_tcp)}
VOLATILE = ("submitted_at", "updated_at")


def _strip(d):
    if not isinstance(d, dict):
        return d
    return {k: v for k, v in d.items() if k not in VOLATILE}


def _listing(root):
    return {sub: sorted(n for n in os.listdir(os.path.join(root, sub))
                        if not n.startswith("."))
            for sub in ("pending", "claimed", "state", "revoked")}


# -- FileBroker ------------------------------------------------------------
@pytest.mark.parametrize("producer,consumer", [("ref", "port"),
                                               ("port", "ref")])
def test_file_broker_interoperates(tmp_path, producer, consumer):
    root = str(tmp_path)
    prod = SIDES[producer][0].FileBroker(root, "producer")
    cons = SIDES[consumer][0].FileBroker(root, "consumer")
    for i, tid in enumerate(("zzz-first", "aaa-second", "mmm-third")):
        prod.enqueue(tid, "work", (i, "x"), {"k": [i]}, queue="q")
        os.utime(os.path.join(root, "pending", f"{tid}.json"), (i, i))
    assert cons.pending_count() == 3
    assert _strip(cons.get_state("aaa-second")) == {"state": "PENDING"}
    task = cons.claim()
    assert task["id"] == "zzz-first" and task["claimed_by"] == "consumer"
    assert (task["args"], task["kwargs"], task["queue"]) == (
        [0, "x"], {"k": [0]}, "q")
    # the consumer's PROGRESS is the producer's reading
    cons.set_state("zzz-first", {"state": "PROGRESS", "info": {"pct": 50}})
    assert prod.get_state("zzz-first") == cons.get_state("zzz-first")
    assert prod.get_state("zzz-first")["info"] == {"pct": 50}
    # a producer's revoke of a pending task: never claimed, REVOKED
    prod.revoke("aaa-second")
    assert cons.is_revoked("aaa-second")
    again = cons.claim()
    assert again["id"] == "mmm-third"
    assert _strip(prod.get_state("aaa-second")) == {"state": "REVOKED"}
    assert cons.claim() is None and prod.claim() is None
    # results ride the state file; finish clears claim, heartbeat, marker
    for tid in ("zzz-first", "mmm-third"):
        cons.set_state(tid, {"state": "SUCCESS", "result": {"n": 1},
                             "traceback": ""})
        cons.finish(tid)
        assert _strip(prod.get_state(tid)) == {
            "state": "SUCCESS", "result": {"n": 1}, "traceback": ""}
    assert _listing(root) == {
        "pending": [], "claimed": [], "revoked": ["aaa-second.json"],
        "state": ["aaa-second.json", "mmm-third.json", "zzz-first.json"]}
    # and the other way round on the same directory
    cons.enqueue("back", "work", (), {})
    assert prod.claim()["claimed_by"] == "producer"


def _file_script(mod, root):
    """One sequence of operations; every answer and the directory
    listing after each step, timestamps stripped."""
    out = []
    live = mod.FileBroker(root, "w", heartbeat_timeout=3600.0,
                          result_ttl=0.0)
    dead = mod.FileBroker(root, "w", heartbeat_timeout=0.0, result_ttl=0.0)

    def step(value):
        out.append((_strip(value) if isinstance(value, dict) else value,
                    _listing(root)))

    for i in range(4):
        live.enqueue(f"t{i}", "work", (i,), {})
        os.utime(os.path.join(root, "pending", f"t{i}.json"), (i, i))
        step(None)
    step(live.claim()["id"])
    step(live.claim()["id"])
    step(live.requeue_stale())  # fresh heartbeats: nothing
    step(dead.requeue_stale())  # both claims stale: requeued
    step(live.get_state("t0"))
    live.revoke("t2")
    step(live.is_revoked("t2"))
    step([live.claim()["id"] for _ in range(3)])
    step(live.claim())
    step(live.get_state("t2"))
    for tid in ("t0", "t1", "t3"):
        live.set_state(tid, {"state": "SUCCESS", "result": tid})
        live.finish(tid)
    step(live.is_revoked("t2"))
    live.revoke("t9")  # a marker of a task that never comes
    for sub in ("state", "revoked"):
        for name in os.listdir(os.path.join(root, sub)):
            if name in ("t1.json", "t9.json"):
                os.utime(os.path.join(root, sub, name), (0, 0))
    dead._last_gc = 0.0
    step(dead.requeue_stale())  # runs the TTL sweep
    step([live.get_state(t) is None for t in ("t0", "t1", "t2", "t3")])
    step(live.is_revoked("t9"))
    step(live.pending_count())
    return out


def test_file_broker_same_sequence_same_answers(tmp_path):
    ref = _file_script(ref_file, str(tmp_path / "ref"))
    port = _file_script(port_file, str(tmp_path / "port"))
    assert len(ref) == len(port) == 18
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, (i, a, b)


def test_claim_without_heartbeat_ages_from_first_sight(tmp_path):
    """A claim whose first heartbeat is not written yet (``claim`` renames
    the task, then writes it) is not taken back at once: it ages from
    when the reaper first saw it, and is requeued once the timeout has
    passed since then (ROADMAP queue 3; the reference requeues it at
    once, and the task runs twice)."""
    root = str(tmp_path)
    worker = port_file.FileBroker(root, "worker")
    worker.enqueue("t", "work", (), {})
    assert worker.claim()["id"] == "t"
    os.unlink(os.path.join(root, "claimed", "t.hb"))
    reaper = port_file.FileBroker(root, "reaper", heartbeat_timeout=0.2)
    t0 = time.time()
    assert reaper.requeue_stale() == []
    assert _listing(root)["claimed"] == ["t.json"]
    deadline = t0 + 60.0
    while True:
        requeued = reaper.requeue_stale()
        if requeued:
            break
        assert time.time() < deadline, _listing(root)
        time.sleep(0.02)
    assert requeued == ["t"] and time.time() - t0 >= 0.2
    assert _listing(root)["pending"] == ["t.json"]
    assert _strip(reaper.get_state("t")) == {"state": "PENDING",
                                             "requeued": True}


def test_producer_does_not_heartbeat_a_claim_it_reads(tmp_path):
    """A producer that reads a task's STARTED state from the broker (its
    ``get_record`` merges it) does not heartbeat that claim: only the
    process that runs a task keeps its claim alive, so a dead worker's
    task is still reclaimed (ROADMAP queue 3)."""
    from vtd_tpu_torch.serve.queue import TaskQueue

    root = str(tmp_path)
    broker = port_file.FileBroker(root, "producer", heartbeat_timeout=3600.0)
    beats, sweeps = [], []
    broker.heartbeat = beats.append
    requeue_stale = broker.requeue_stale
    broker.requeue_stale = lambda: sweeps.append(1) or requeue_stale()
    producer = TaskQueue(concurrency=0, broker=broker)
    producer.task(name="work")(lambda self: None)  # registration only
    try:
        res = producer.tasks["work"].apply_async(task_id="t")
        worker = port_file.FileBroker(root, "worker")
        assert worker.claim()["id"] == "t"
        worker.set_state("t", {"state": "STARTED"})
        rec = producer.get_record("t")
        assert rec.state == res.state == "STARTED"
        assert rec.started_at is None
        # two whole monitor passes after the merge
        seen = len(sweeps)
        deadline = time.time() + 60.0
        while len(sweeps) < seen + 2:
            assert time.time() < deadline, "the monitor made no passes"
            time.sleep(0.02)
        assert beats == []
    finally:
        producer.shutdown()


# -- TcpBroker / BrokerServer ----------------------------------------------
@pytest.fixture(params=[("ref", "port"), ("port", "ref")],
                ids=["ref_daemon-port_client", "port_daemon-ref_client"])
def tcp(request):
    server_side, client_side = request.param
    srv = SIDES[server_side][1].BrokerServer(
        "127.0.0.1", 0, token="s3cret", heartbeat_timeout=0.2,
        reap_interval=3600.0)  # reaped by hand below
    srv.start()

    def client(name="w", token="s3cret"):
        return SIDES[client_side][1].TcpBroker(
            srv.host, srv.port, worker_id=name, token=token)

    try:
        yield srv, client
    finally:
        srv.shutdown()


def test_tcp_ping_roundtrip_and_exclusive_claim(tcp):
    srv, client = tcp
    br = client()
    assert br.ping()
    br.enqueue("t1", "work", (1, 2), {"k": "v"}, queue="q")
    assert br.pending_count() == 1
    assert br.get_state("t1")["state"] == "PENDING"
    a, b = client("a"), client("b")
    pa, pb = a.claim(), b.claim()
    assert (pa is None) != (pb is None)
    p = pa or pb
    assert p["id"] == "t1" and p["args"] == [1, 2]
    assert p["kwargs"] == {"k": "v"} and p["queue"] == "q"
    assert p["claimed_by"] in ("a", "b") and "_seq" not in p
    br.set_state("t1", {"state": "SUCCESS", "result": 3})
    assert br.get_state("t1")["result"] == 3
    br.finish("t1")
    assert br.pending_count() == 0
    assert srv.state.stats() == {"pending": 0, "claimed": 0, "states": 1,
                                 "revoked": 0}


def test_tcp_fifo_requeue_keeps_position(tcp):
    srv, client = tcp
    br = client()
    for tid in ("zzz-first", "aaa-second", "mmm-third"):
        br.enqueue(tid, "work", (), {})
    assert br.claim()["id"] == "zzz-first"
    time.sleep(0.3)  # the claim's heartbeat goes stale (timeout 0.2 s)
    assert br.requeue_stale() == []  # the client leaves it to the daemon
    assert srv.state.requeue_stale() == ["zzz-first"]
    assert br.get_state("zzz-first")["requeued"] is True
    assert [br.claim()["id"] for _ in range(3)] == [
        "zzz-first", "aaa-second", "mmm-third"]


def test_tcp_revoke_while_pending_never_runs(tcp):
    _, client = tcp
    br = client()
    br.enqueue("t1", "work", (), {})
    br.enqueue("t2", "work", (), {})
    br.revoke("t1")
    assert br.is_revoked("t1") and not br.is_revoked("t2")
    assert br.claim()["id"] == "t2"
    assert br.claim() is None
    assert br.get_state("t1")["state"] == "REVOKED"
    br.finish("t1")
    assert not br.is_revoked("t1")


def test_tcp_token_auth_refuses_wrong_token(tcp):
    _, client = tcp
    assert client().ping()
    for token in ("wrong", ""):
        with pytest.raises(RuntimeError, match="auth"):
            client(token=token).ping()


def _tcp_script(br):
    br.enqueue("a", "work", (), {})
    br.enqueue("b", "work", (), {})
    br.enqueue("c", "work", (), {})
    br.revoke("b")
    br.revoke("zz")
    br.claim()
    br.claim()
    br.set_state("x", {"state": "SUCCESS"})


def test_tcp_stats_equal_across_daemons():
    stats = []
    for mods in (ref_tcp, port_tcp):
        srv = mods.BrokerServer("127.0.0.1", 0, reap_interval=3600.0)
        srv.start()
        try:
            other = port_tcp if mods is ref_tcp else ref_tcp
            _tcp_script(other.TcpBroker(srv.host, srv.port))
            stats.append(srv.state.stats())
        finally:
            srv.shutdown()
    assert stats[0] == stats[1] == {"pending": 0, "claimed": 2,
                                    "states": 4, "revoked": 2}


# -- settings and health ---------------------------------------------------
@pytest.mark.parametrize("scheme", ["file", "tcp"])
def test_broker_urls_build_brokers(scheme, tmp_path, monkeypatch):
    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.serve import queue

    url = (f"file://{tmp_path}/q" if scheme == "file"
           else "tcp://broker.example:6380")
    monkeypatch.setattr(settings, "celery_broker_url", url)
    br = queue._broker_from_settings()
    if scheme == "file":
        assert isinstance(br, port_file.FileBroker)
        assert sorted(os.listdir(tmp_path / "q")) == [
            "claimed", "pending", "revoked", "state"]
    else:
        assert isinstance(br, port_tcp.TcpBroker)
        assert (br.host, br.port) == ("broker.example", 6380)
        monkeypatch.setattr(settings, "celery_broker_url", "tcp://nohost")
        with pytest.raises(ValueError, match="malformed"):
            queue._broker_from_settings()


@pytest.mark.parametrize("scheme", ["file", "tcp", "local"])
def test_health_reports_the_configured_broker(scheme, tmp_path,
                                              monkeypatch):
    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.obs.health import HealthCheck

    srv = None
    if scheme == "file":
        good = f"file://{tmp_path}/q"
        port_file.FileBroker(str(tmp_path / "q")).enqueue("t", "w", (), {})
        bad = f"file://{tmp_path}/absent"
    elif scheme == "tcp":
        srv = port_tcp.BrokerServer("127.0.0.1", 0, reap_interval=3600.0)
        srv.start()
        port_tcp.TcpBroker(srv.host, srv.port).enqueue("t", "w", (), {})
        good = f"tcp://{srv.host}:{srv.port}"
        bad = None
    else:
        good, bad = "local://", None
    try:
        monkeypatch.setattr(settings, "celery_broker_url", good)
        out = asyncio.run(HealthCheck().check_queue())
        assert out["status"] == "healthy" and out["backend"] == scheme, out
        if scheme != "local":
            assert out["pending_tasks"] == 1
        else:
            assert "workers" in out
        if scheme == "tcp":
            srv.shutdown()
            srv = None
            bad = good  # the daemon is gone
        if bad:
            monkeypatch.setattr(settings, "celery_broker_url", bad)
            out = asyncio.run(HealthCheck().check_queue())
            assert out["status"] == "unhealthy" and out["backend"] == scheme
    finally:
        if srv is not None:
            srv.shutdown()
