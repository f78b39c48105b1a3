"""Network task broker: a TCP daemon + client with the FileBroker
contract (port of ``vtd_tpu/serve/brokerd.py``; the wire protocol and the
token auth are the same, so a port worker can drain a queue that the JAX
package's daemon serves, and the other way round).

The reference distributes whole-video tasks to N GPU workers through a
Redis server (reference ``app/celery_app.py:14-34``; 2-8 worker
replicas, ``k8s/deployment.yaml:127-189``). The shared-filesystem
``FileBroker`` (serve/broker.py) needs a mount that every host shares;
this module covers fleets with *no shared filesystem* — the genuinely
Redis-shaped deployment — with a dependency-free stdlib daemon:

  * ``python -m vtd_tpu_torch brokerd --port 6380`` runs the server
    (threaded TCP, newline-delimited JSON requests, in-memory state —
    the same durability contract as default Redis). It logs
    ``brokerd listening on HOST:PORT`` once bound (``--port 0`` picks a
    free port).
  * ``CELERY_BROKER_URL=tcp://host:6380`` gives every API/worker
    replica a :class:`TcpBroker`, which implements exactly the
    ``FileBroker`` method surface (serve/broker.py), so ``TaskQueue``
    needs no changes.
  * Elasticity parity: claims carry server-side heartbeats; a reaper
    requeues tasks whose worker stopped heartbeating, preserving FIFO
    position (original submit order). Results/revoke markers expire
    after ``result_ttl``.
  * Optional shared-secret auth: start the daemon with ``--token`` (or
    ``VTD_BROKER_TOKEN``) and give clients the same token — connections
    with a missing/wrong token are refused. Like Redis AUTH, transport
    encryption is out of scope: deploy on a trusted network.
"""
from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_MAX_LINE = 16 * 1024 * 1024  # one request line (task args ride in it)


class BrokerState:
    """In-memory broker state + operations (single lock; every op is a
    dict-in/dict-out transaction so the TCP layer stays dumb)."""

    def __init__(self, heartbeat_timeout: float = 30.0,
                 result_ttl: float = 86400.0):
        self.heartbeat_timeout = heartbeat_timeout
        self.result_ttl = result_ttl
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self.pending: Dict[str, Dict[str, Any]] = {}
        self.claimed: Dict[str, Dict[str, Any]] = {}
        self.heartbeats: Dict[str, float] = {}
        self.states: Dict[str, Dict[str, Any]] = {}
        self.revoked: Dict[str, float] = {}
        self._last_gc = 0.0

    # -- ops (mirror FileBroker semantics) ------------------------------
    def enqueue(self, task_id: str, name: str, args: list, kwargs: dict,
                queue: str = "default") -> None:
        payload = {
            "id": task_id, "name": name, "args": list(args),
            "kwargs": kwargs, "queue": queue,
            "submitted_at": time.time(), "_seq": next(self._seq),
        }
        with self._lock:
            self.states[task_id] = {
                "state": "PENDING", "updated_at": time.time(),
            }
            self.pending[task_id] = payload

    def claim(self, worker_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            while True:
                if not self.pending:
                    return None
                # FIFO by original submit order — requeued tasks keep
                # their position (FileBroker's rename preserves mtime)
                tid = min(
                    self.pending,
                    key=lambda t: (self.pending[t]["submitted_at"],
                                   self.pending[t]["_seq"]),
                )
                payload = self.pending.pop(tid)
                if tid in self.revoked:
                    self.states[tid] = {
                        "state": "REVOKED", "updated_at": time.time(),
                    }
                    continue
                payload = dict(payload, claimed_by=worker_id)
                self.claimed[tid] = payload
                self.heartbeats[tid] = time.time()
                out = dict(payload)
                out.pop("_seq", None)
                return out

    def heartbeat(self, task_id: str) -> None:
        with self._lock:
            if task_id in self.claimed:
                self.heartbeats[task_id] = time.time()

    def finish(self, task_id: str) -> None:
        with self._lock:
            self.claimed.pop(task_id, None)
            self.heartbeats.pop(task_id, None)
            self.revoked.pop(task_id, None)

    def set_state(self, task_id: str, state: Dict[str, Any]) -> None:
        with self._lock:
            self.states[task_id] = dict(state, updated_at=time.time())

    def get_state(self, task_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self.states.get(task_id)

    def revoke(self, task_id: str) -> None:
        with self._lock:
            self.revoked[task_id] = time.time()

    def is_revoked(self, task_id: str) -> bool:
        with self._lock:
            return task_id in self.revoked

    def requeue_stale(self) -> List[str]:
        now = time.time()
        requeued = []
        with self._lock:
            for tid in list(self.claimed):
                if now - self.heartbeats.get(tid, 0.0) \
                        < self.heartbeat_timeout:
                    continue
                payload = self.claimed.pop(tid)
                self.heartbeats.pop(tid, None)
                payload.pop("claimed_by", None)
                self.pending[tid] = payload
                self.states[tid] = {
                    "state": "PENDING", "requeued": True,
                    "updated_at": now,
                }
                requeued.append(tid)
                logger.warning("requeued stale task %s", tid)
            self._gc(now)
        return requeued

    def _gc(self, now: float) -> None:
        if now - self._last_gc < 300.0:
            return
        self._last_gc = now
        cutoff = now - self.result_ttl
        # Never expire records of tasks still in the queue: dropping a
        # pending task's revoke marker would let the revoked job RUN
        # when finally claimed; dropping its state makes other replicas
        # report the queued job as unknown.
        live = self.pending.keys() | self.claimed.keys()
        for tid in [t for t, s in self.states.items()
                    if s.get("updated_at", 0.0) < cutoff
                    and t not in live]:
            del self.states[tid]
        for tid in [t for t, ts in self.revoked.items()
                    if ts < cutoff and t not in live]:
            del self.revoked[tid]

    def pending_count(self) -> int:
        with self._lock:
            return len(self.pending)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "pending": len(self.pending),
                "claimed": len(self.claimed),
                "states": len(self.states),
                "revoked": len(self.revoked),
            }


class BrokerServer:
    """Threaded TCP server around :class:`BrokerState`.

    Wire format: one JSON request line per connection,
    ``{"op": ..., "token": ..., **op_args}`` -> one JSON response line
    ``{"ok": true, "result": ...}`` / ``{"ok": false, "error": ...}``.
    """

    OPS = {
        "enqueue", "claim", "heartbeat", "finish", "set_state",
        "get_state", "revoke", "is_revoked", "requeue_stale",
        "pending_count", "stats", "ping",
    }

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None,
                 heartbeat_timeout: float = 30.0,
                 result_ttl: float = 86400.0,
                 reap_interval: float = 10.0):
        self.state = BrokerState(heartbeat_timeout, result_ttl)
        self.token = token if token is not None else os.environ.get(
            "VTD_BROKER_TOKEN"
        )
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            # Idle/half-open connections must not pin handler threads
            # forever (reachable pre-auth): the socket times out and the
            # connection closes; clients reconnect transparently.
            timeout = 60

            def handle(self):
                # Persistent connections: one request line -> one
                # response line, looped until EOF/idle-timeout. Workers
                # poll claim at 10 Hz — per-op connections would churn
                # hundreds of sockets+threads per second across a fleet.
                while True:
                    try:
                        line = self.rfile.readline(_MAX_LINE)
                    except (TimeoutError, OSError):
                        return
                    if not line:
                        return
                    try:
                        req = json.loads(line)
                        resp = outer._dispatch(req)
                    except ValueError as e:
                        resp = {"ok": False, "error": f"bad request: {e}"}
                    except Exception as e:  # noqa: BLE001 — report only
                        logger.exception("broker op failed")
                        resp = {"ok": False, "error": repr(e)}
                    try:
                        self.wfile.write(json.dumps(resp).encode() + b"\n")
                        self.wfile.flush()
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._reap_interval = reap_interval

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if self.token and req.get("token") != self.token:
            return {"ok": False, "error": "auth failed"}
        op = req.get("op")
        if op not in self.OPS:
            return {"ok": False, "error": f"unknown op {op!r}"}
        if op == "ping":
            return {"ok": True, "result": "pong"}
        st = self.state
        if op == "enqueue":
            st.enqueue(req["id"], req["name"], req.get("args", []),
                       req.get("kwargs", {}), req.get("queue", "default"))
            return {"ok": True, "result": None}
        if op == "claim":
            return {"ok": True, "result": st.claim(req.get("worker", "?"))}
        if op == "set_state":
            st.set_state(req["id"], req["state"])
            return {"ok": True, "result": None}
        if op in ("heartbeat", "finish", "revoke"):
            getattr(st, op)(req["id"])
            return {"ok": True, "result": None}
        if op in ("get_state", "is_revoked"):
            return {"ok": True, "result": getattr(st, op)(req["id"])}
        # requeue_stale / pending_count / stats
        return {"ok": True, "result": getattr(st, op)()}

    def start(self) -> None:
        t = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="vtd-brokerd",
        )
        t.start()
        self._threads.append(t)
        r = threading.Thread(
            target=self._reap_loop, daemon=True, name="vtd-brokerd-reaper"
        )
        r.start()
        self._threads.append(r)

    def _reap_loop(self) -> None:
        while not self._stop.wait(self._reap_interval):
            try:
                self.state.requeue_stale()
            except Exception:  # noqa: BLE001
                logger.exception("broker reaper failed")

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.wait(3600.0):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()


class TcpBroker:
    """Client for :class:`BrokerServer` with the exact ``FileBroker``
    method surface (serve/broker.py) — drop-in for ``TaskQueue``.

    One persistent connection per broker object (request/response lines
    are serialized under a lock): workers poll ``claim`` at 10 Hz and
    the monitor heartbeats at 4 Hz, so per-op connections would churn
    hundreds of sockets a second across a fleet. A dead/restarted/
    idle-timed-out daemon is handled by one transparent reconnect per
    operation; a retried ``claim`` whose first attempt was actually
    served strands that task only until its heartbeat goes stale and
    the server reaper requeues it (the normal elasticity path).
    """

    def __init__(self, host: str, port: int,
                 worker_id: Optional[str] = None,
                 token: Optional[str] = None,
                 timeout: float = 10.0,
                 heartbeat_timeout: float = 30.0):
        self.host, self.port = host, int(port)
        self.worker_id = worker_id or f"{socket.gethostname()}-{os.getpid()}"
        self.token = token if token is not None else os.environ.get(
            "VTD_BROKER_TOKEN"
        )
        self.timeout = timeout
        # kept for API parity (enforced server-side)
        self.heartbeat_timeout = heartbeat_timeout
        self._lock = threading.Lock()
        self._conn: Optional[Tuple[socket.socket, Any]] = None

    def _close_locked(self) -> None:
        if self._conn is not None:
            s, f = self._conn
            self._conn = None
            for obj in (f, s):
                try:
                    obj.close()
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _rpc(self, op: str, **kw) -> Any:
        req = dict(kw, op=op)
        if self.token:
            req["token"] = self.token
        data = json.dumps(req).encode() + b"\n"
        with self._lock:
            line = b""
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        s = socket.create_connection(
                            (self.host, self.port), timeout=self.timeout
                        )
                        s.settimeout(self.timeout)
                        self._conn = (s, s.makefile("rwb"))
                    _, f = self._conn
                    f.write(data)
                    f.flush()
                    line = f.readline(_MAX_LINE)
                    if not line:
                        raise ConnectionError(
                            "broker closed the connection"
                        )
                    break
                except (OSError, ConnectionError):
                    self._close_locked()
                    if attempt:
                        raise
        resp = json.loads(line)
        if not resp.get("ok"):
            raise RuntimeError(f"broker error: {resp.get('error')}")
        return resp.get("result")

    # -- FileBroker surface ---------------------------------------------
    def enqueue(self, task_id: str, name: str, args: tuple, kwargs: dict,
                queue: str = "default") -> None:
        self._rpc("enqueue", id=task_id, name=name, args=list(args),
                  kwargs=kwargs, queue=queue)

    def claim(self) -> Optional[Dict[str, Any]]:
        return self._rpc("claim", worker=self.worker_id)

    def heartbeat(self, task_id: str) -> None:
        self._rpc("heartbeat", id=task_id)

    def finish(self, task_id: str) -> None:
        self._rpc("finish", id=task_id)

    def set_state(self, task_id: str, state: Dict[str, Any]) -> None:
        self._rpc("set_state", id=task_id, state=state)

    def get_state(self, task_id: str) -> Optional[Dict[str, Any]]:
        return self._rpc("get_state", id=task_id)

    def revoke(self, task_id: str) -> None:
        self._rpc("revoke", id=task_id)

    def is_revoked(self, task_id: str) -> bool:
        return bool(self._rpc("is_revoked", id=task_id))

    def requeue_stale(self) -> List[str]:
        """No-op client-side: the daemon's own reaper thread requeues
        stale claims every few seconds — N clients each asking for a
        sweep at 4 Hz would be pure load. (The ``requeue_stale`` op
        still exists server-side for tests/tools.)"""
        return []

    def pending_count(self) -> int:
        return int(self._rpc("pending_count"))

    def ping(self) -> bool:
        return self._rpc("ping") == "pong"


def parse_tcp_url(url: str) -> Tuple[str, int]:
    """``tcp://host:port`` -> (host, port)."""
    rest = url[len("tcp://"):]
    host, _, port = rest.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"malformed broker URL {url!r}; expected tcp://host:port"
        )
    return host, int(port)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="vtd_tpu_torch brokerd",
        description="vtd_tpu_torch network task broker daemon",
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6380)
    parser.add_argument("--token", default=None,
                        help="shared secret (default: $VTD_BROKER_TOKEN)")
    parser.add_argument("--heartbeat-timeout", type=float, default=30.0)
    parser.add_argument("--result-ttl", type=float, default=86400.0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = BrokerServer(
        args.host, args.port, token=args.token,
        heartbeat_timeout=args.heartbeat_timeout,
        result_ttl=args.result_ttl,
    )
    logger.info("brokerd listening on %s:%d", server.host, server.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
