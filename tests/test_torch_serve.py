"""The port's REST service against ``vtd_tpu``'s, in one process.

Both apps run side by side, each with its own in-memory SQLite
(``sqlite://``), temp dirs and job queue, and a ``configure_pipeline``
at ``detector_input_size=160`` reading the same ``demo_models2/``
checkpoints (the port on ``device="cpu"``; the reference computing in
float32, as in ``tests/test_torch_pipeline.py``). One scripted session
goes through both ``TestClient``s step by step: status codes must be
equal, and bodies equal once ids, tokens, file names, paths and
timestamps are normalised. Job results are compared at the tolerances of
``tests/test_torch_pipeline.py::test_process_video_matches_reference``
(transcripts equal, boxes at IoU >= 0.95, counts and texts of the summary
equal), and scores within ``SCORE_ATOL``.

Jobs are awaited on the queue's postrun signal with a deadline, never by
sleeping.
"""
import asyncio
import csv
import importlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import xml.etree.ElementTree as ET

import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "demo_models2", "dbnet", "best_bf16")
CRNN = os.path.join(REPO, "demo_models2", "crnn", "crnn_final")
TROCR = os.path.join(REPO, "demo_models2", "trocr", "trocr_final")
PIPE = dict(
    detector_path=DET, recognizer_path=CRNN, transformer_path=TROCR,
    batch_size=4, max_dets=16, detector_input_size=160,
    decode_backend="cv2", rec_chunk=16, recognizer_kwargs={"pad_batch": 32},
)
JOB_DEADLINE_S = 120.0
# Boxes: IoU >= 0.95 (test_process_video_matches_reference). Scores:
# both packages ship them as float16 (quantum 2^-11 near 1) from float32
# maps whose convolutions sum in different orders; 2e-3 is four quanta.
IOU_MIN = 0.95
SCORE_ATOL = 2e-3
SCORE_KEYS = {
    "detection_confidence", "recognition_confidence", "confidence",
    "avg_detection_confidence", "avg_recognition_confidence",
}
# values that differ by construction: ids minted at random, wall-clock
# times, tokens, temp paths
VOLATILE = {
    "access_token", "created_at", "updated_at", "started_at",
    "completed_at", "filename", "file_path", "celery_task_id",
    "processing_time_seconds", "fps_processed", "response_time_ms",
}


def _float32_reference(pipe):
    """The reference pipeline computing in float32 on float32 weights
    (see tests/test_torch_pipeline.py:_reference_pipeline)."""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.crnn import CRNN as RefCRNN
    from vtd_tpu.models.dbnet import DBNet

    pipe.detector.model = DBNet(dtype=jnp.float32)
    pipe.detector.variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), pipe.detector.variables
    )
    if pipe.recognizer.crnn is not None:
        pipe.recognizer.crnn = RefCRNN(dtype=jnp.float32)
    pipe._detect_crop = pipe._build_detect_crop()


def write_clip(path):
    """2-second 320x240 @ 30 fps clip: 'HELLO WORLD' on white for the
    first second, '123 HELLO' on light gray for the second (a hard scene
    change for the keyframe gate); 20 stride candidates at 10 fps."""
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (320, 240)
    )
    for i in range(60):
        first = i < 30
        frame = np.full((240, 320, 3), 255 if first else 200, np.uint8)
        cv2.putText(frame, "HELLO WORLD" if first else "123 HELLO",
                    (20, 120), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 0), 2)
        writer.write(frame)
    writer.release()
    return path


class NoLimit:
    def incr_window(self, key, window_s):
        return 0


class Side:
    """One package's service: settings, DB, queue hook and client."""

    def __init__(self, pkg, tmp, mp, pipeline_kwargs):
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.pkg = pkg
        self.settings = mod("core.config").settings
        self.tasks = mod("serve.tasks")
        self.queue = mod("serve.queue").task_queue
        dbmod = mod("serve.db.database")
        for key, sub in (("temp_dir", "temp"), ("output_dir", "out"),
                         ("model_path", "models")):
            os.makedirs(tmp / sub, exist_ok=True)
            mp.setattr(self.settings, key, str(tmp / sub))
        self.db = dbmod.Database("sqlite://")
        self.db.init_db()
        mp.setattr(dbmod, "_default_db", self.db)
        self.tasks.configure_pipeline(**pipeline_kwargs)
        self._done = {}
        self._lock = threading.Lock()
        self.queue.on_postrun.append(self._on_postrun)
        storage = mod("serve.services.storage_service").StorageService(
            base_dir=str(tmp / "uploads")
        )
        app = mod("serve.app").create_app(
            start_worker=False, rate_limit_store=NoLimit(),
            storage_service=storage,
        )
        self.client = mod("serve.http").TestClient(app)
        self.headers = {}
        self.ids = {}

    def _event(self, task_id):
        with self._lock:
            return self._done.setdefault(task_id, threading.Event())

    def _on_postrun(self, rec):
        self._event(rec.id).set()

    def wait(self, task_id):
        assert self._event(task_id).wait(JOB_DEADLINE_S), (
            f"{self.pkg}: task {task_id} not done in {JOB_DEADLINE_S} s"
        )

    def close(self):
        self.queue.on_postrun.remove(self._on_postrun)
        self.tasks.configure_pipeline()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(str(tmp_path_factory.mktemp("vid") / "clip.mp4"))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    ref = Side("vtd_tpu", tmp_path_factory.mktemp("ref"), mp, PIPE)
    port = Side("vtd_tpu_torch", tmp_path_factory.mktemp("port"), mp,
                dict(PIPE, device="cpu"))
    # build both reference engines now and move them to float32
    for engine in (False, True):
        _float32_reference(ref.tasks.get_pipeline(engine))
    try:
        yield ref, port
    finally:
        ref.close()
        port.close()
        mp.undo()


def both(sides, fn):
    """Run one step on both services; status codes must be equal."""
    ref, port = sides
    a, b = fn(ref), fn(port)
    assert a.status_code == b.status_code, (
        a.status_code, a.render()[:300], b.status_code, b.render()[:300]
    )
    return a, b


def _iou(a, b):
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1)


def same(a, b, where="body"):
    """``a`` (the reference's) and ``b`` (the port's) agree: volatile
    values are only required to be present, boxes match at IOU_MIN,
    scores within SCORE_ATOL, everything else is equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (
            where, sorted(a), sorted(b) if isinstance(b, dict) else b)
        keys = set(a)
        if "bbox_x1" in a:  # a text_detections row
            box = ("bbox_x1", "bbox_y1", "bbox_x2", "bbox_y2")
            assert _iou([a[k] for k in box], [b[k] for k in box]) >= IOU_MIN
            keys -= set(box)
        for k in keys:
            sub = f"{where}.{k}"
            if k in VOLATILE:
                continue
            if k == "bbox":
                assert _iou(a[k], b[k]) >= IOU_MIN, (sub, a[k], b[k])
            elif k == "polygon":
                assert np.shape(a[k]) == np.shape(b[k]), sub
            elif k in SCORE_KEYS:
                assert abs(a[k] - b[k]) <= SCORE_ATOL, (sub, a[k], b[k])
            else:
                same(a[k], b[k], sub)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def same_csv(a, b):
    ra = list(csv.reader(io.StringIO(a)))
    rb = list(csv.reader(io.StringIO(b)))
    assert ra[0] == rb[0] and len(ra) == len(rb)
    for x, y in zip(ra[1:], rb[1:]):
        assert x[:3] == y[:3]  # frame_number, timestamp, text
        assert _iou([int(v) for v in x[3:7]],
                    [int(v) for v in y[3:7]]) >= IOU_MIN
        for u, v in zip(x[7:], y[7:]):
            assert abs(float(u) - float(v)) <= SCORE_ATOL
    return len(ra) - 1


def same_xml(a, b):
    ta, tb = ET.fromstring(a), ET.fromstring(b)
    same(
        {"summary": {e.tag: _num(e.text) for e in ta.find("summary")}},
        {"summary": {e.tag: _num(e.text) for e in tb.find("summary")}},
    )
    fa, fb = ta.find("frames"), tb.find("frames")
    assert len(fa) == len(fb)
    n = 0
    for x, y in zip(fa, fb):
        assert x.attrib == y.attrib  # frame number and timestamp
        assert len(x) == len(y)
        for ox, oy in zip(x, y):
            assert ox.get("transcription") == oy.get("transcription")
            for k in ("detection_confidence", "recognition_confidence"):
                assert abs(float(ox.get(k)) - float(oy.get(k))) <= SCORE_ATOL
            box = lambda o: [int(o[i].get(c)) for i, c in  # noqa: E731
                             ((0, "x"), (0, "y"), (2, "x"), (2, "y"))]
            assert _iou(box(ox), box(oy)) >= IOU_MIN
            n += 1
    return n


def _num(text):
    try:
        return json.loads(text.replace("'", '"'))
    except ValueError:
        return text


def upload(side, name, content, **kw):
    return side.client.post("/api/v1/videos/upload",
                            files={"file": (name, content)},
                            headers=side.headers, **kw)


def run_job(sides, params):
    """Start a detect job on both services, wait for both, and return the
    two status bodies."""
    def start(s):
        return s.client.post(
            f"/api/v1/processing/videos/{s.ids['video']}/detect",
            params=params, headers=s.headers,
        )

    a, b = both(sides, start)
    assert a.status_code == 200, a.render()
    same(a.json(), b.json())
    for s, r in zip(sides, (a, b)):
        s.ids["job"] = r.json()["id"]
        s.wait(r.json()["celery_task_id"])
    a, b = both(sides, lambda s: s.client.get(
        f"/api/v1/processing/jobs/{s.ids['job']}/status", headers=s.headers))
    same(a.json(), b.json())
    assert b.json()["status"] == "completed", b.json()
    return a.json(), b.json()


def results(sides, fmt=None):
    a, b = both(sides, lambda s: s.client.get(
        f"/api/v1/processing/videos/{s.ids['video']}/results",
        params={"format": fmt} if fmt else None, headers=s.headers))
    assert a.status_code == 200
    return a.json(), b.json()


# -- the scripted session (one module-scoped state, steps in order) ------
def test_session_root_app_and_auth(sides):
    a, b = both(sides, lambda s: s.client.get("/"))
    same(a.json(), b.json())
    a, b = both(sides, lambda s: s.client.get("/app"))
    nonce = re.compile(r'nonce(-|=")[A-Za-z0-9_\-]{16,}')
    strip = lambda r: nonce.sub("N", r.render().decode())  # noqa: E731
    assert strip(a) == strip(b)

    user = {"email": "ann@example.com", "username": "ann", "password": "pw1"}
    a, b = both(sides, lambda s: s.client.post("/api/v1/auth/register",
                                               json_body=user))
    assert a.status_code == 201
    same(a.json(), b.json())
    for step in (
        lambda s: s.client.post("/api/v1/auth/register", json_body=user),
        lambda s: s.client.post("/api/v1/auth/register", json_body=dict(
            user, email="other@example.com")),
        lambda s: s.client.post("/api/v1/auth/login", data={
            "username": "ann", "password": "wrong"}),
        lambda s: s.client.get("/api/v1/auth/me"),
    ):
        a, b = both(sides, step)
        assert a.status_code in (400, 401)
        assert a.json() == b.json()
    a, b = both(sides, lambda s: s.client.post("/api/v1/auth/login", data={
        "username": "ann", "password": "pw1"}))
    assert a.status_code == 200
    same(a.json(), b.json())
    for s, r in zip(sides, (a, b)):
        s.headers = {"Authorization": f"Bearer {r.json()['access_token']}"}
    a, b = both(sides, lambda s: s.client.get("/api/v1/auth/me",
                                              headers=s.headers))
    assert a.status_code == 200 and "hashed_password" not in b.json()
    same(a.json(), b.json())
    a, b = both(sides, lambda s: s.client.post("/api/v1/auth/refresh",
                                               headers=s.headers))
    same(a.json(), b.json())


def test_session_videos(sides, clip, monkeypatch):
    content = open(clip, "rb").read()
    a, b = both(sides, lambda s: upload(s, "notes.txt", b"x"))
    assert a.status_code == 400 and a.json() == b.json()
    for s in sides:
        monkeypatch.setattr(s.settings, "max_file_size", 1000)
    a, b = both(sides, lambda s: upload(s, "clip.mp4", content))
    assert a.status_code == 413 and a.json() == b.json()
    monkeypatch.undo()

    a, b = both(sides, lambda s: upload(s, "clip.mp4", content,
                                        params={"category": "street_indoor"}))
    assert a.status_code == 201, a.render()
    same(a.json(), b.json())
    for s, r in zip(sides, (a, b)):
        s.ids["video"] = r.json()["id"]
    a, b = both(sides, lambda s: s.client.get("/api/v1/videos/",
                                              headers=s.headers))
    same(a.json(), b.json())
    a, b = both(sides, lambda s: s.client.get(
        f"/api/v1/videos/{s.ids['video']}", headers=s.headers))
    same(a.json(), b.json())
    a, b = both(sides, lambda s: s.client.put(
        f"/api/v1/videos/{s.ids['video']}", json_body={"category": "sports"},
        headers=s.headers))
    assert b.json()["category"] == "sports"
    same(a.json(), b.json())
    a, b = both(sides, lambda s: s.client.put(
        f"/api/v1/videos/{s.ids['video']}", json_body={"category": "nope"},
        headers=s.headers))
    assert a.status_code == 422 and a.json() == b.json()
    a, b = both(sides, lambda s: s.client.get("/api/v1/videos/999",
                                              headers=s.headers))
    assert a.status_code == 404 and a.json() == b.json()
    a, b = both(sides, lambda s: s.client.get(
        f"/api/v1/videos/{s.ids['video']}/thumbnail", headers=s.headers))
    assert a.status_code == 200 and a.render() == b.render()
    assert a.media_type == b.media_type == "image/jpeg"
    a, b = both(sides, lambda s: s.client.get(
        f"/api/v1/processing/videos/{s.ids['video']}/results",
        headers=s.headers))
    assert a.status_code == 404 and a.json() == b.json()


def test_session_detect_crnn(sides):
    from vtd_tpu_torch.obs import metrics

    before = metrics.model_inference_duration.labels("DBNet-CRNN")._counts
    before = sum(before)
    a, b = run_job(sides, {"use_transformer": "false"})
    assert b["processed_frames"] == b["total_frames"] == 20
    ra, rb = results(sides)
    same(ra, rb)
    assert rb["summary"]["total_detections"] > 0
    assert rb["summary"]["detected_texts"], "the demo models read nothing"
    # the port's pipeline counted its batches: 20 frames in batches of 4
    after = sum(metrics.model_inference_duration.labels("DBNet-CRNN")._counts)
    assert after - before == 5
    ca, cb = results(sides, "csv")
    rows = same_csv(ca["content"], cb["content"])
    assert rows == rb["summary"]["total_detections"]
    xa, xb = results(sides, "xml")
    assert same_xml(xa["content"], xb["content"]) == rows
    a, b = both(sides, lambda s: s.client.get(
        f"/api/v1/videos/{s.ids['video']}",
        params={"include_detections": "true"}, headers=s.headers))
    same(a.json(), b.json())
    assert len(b.json()["frames"]) == 20


def test_session_detect_trocr(sides):
    from vtd_tpu_torch.obs import metrics

    occ = metrics.recognizer_chunk_occupancy
    n0, s0 = sum(occ._counts), occ._sum
    run_job(sides, {"use_transformer": "true"})
    ra, rb = results(sides)
    same(ra, rb)
    assert rb["summary"]["total_detections"] > 0
    # one occupancy sample per recognizer chunk of 16 crops
    per_batch = [
        sum(len(f["detections"]) for f in rb["results"]["results"][i:i + 4])
        for i in range(0, 20, 4)
    ]
    chunks = [min(16, n - c) for n in per_batch for c in range(0, n, 16)]
    assert sum(occ._counts) - n0 == len(chunks)
    assert occ._sum - s0 == pytest.approx(sum(chunks) / 16)


def test_session_detect_keyframe(sides):
    run_job(sides, {"use_transformer": "false", "sample_mode": "keyframe"})
    ra, rb = results(sides)
    same(ra, rb)
    frames = rb["results"]["results"]
    # every stride candidate is covered, most of them by propagation
    assert [f["frame_number"] for f in frames] == list(range(20))
    dups = [f for f in frames if "duplicate_of" in f]
    assert 0 < len(dups) < 20
    kept = {f["frame_number"]: f for f in frames if "duplicate_of" not in f}
    for f in dups:
        assert [d["text"] for d in f["detections"]] == [
            d["text"] for d in kept[f["duplicate_of"]]["detections"]]
    a, b = both(sides, lambda s: s.client.get(
        f"/api/v1/processing/videos/{s.ids['video']}/annotated",
        headers=s.headers))
    assert a.status_code == 200 and a.media_type == b.media_type
    assert len(b.render()) > 1000


def test_session_cancel_and_conflict(sides):
    """Two blocking tasks hold both worker threads, so the detect job
    stays queued: a second detect conflicts, cancel revokes it."""
    release, started = threading.Event(), []
    for s in sides:
        name = f"_block_{s.pkg}"
        evs = [threading.Event(), threading.Event()]
        started += evs

        def block(self, i, _evs=evs):
            _evs[i].set()
            assert release.wait(JOB_DEADLINE_S)

        task = s.queue.task(name=name)(block)
        s.ids["blockers"] = [task.delay(i) for i in range(2)]
    try:
        for ev in started:
            assert ev.wait(JOB_DEADLINE_S)

        def detect(s):
            return s.client.post(
                f"/api/v1/processing/videos/{s.ids['video']}/detect",
                params={"use_transformer": "false"}, headers=s.headers)

        a, b = both(sides, detect)
        same(a.json(), b.json())
        for s, r in zip(sides, (a, b)):
            s.ids["job"] = r.json()["id"]
        a, b = both(sides, detect)
        assert a.status_code == 409 and a.json() == b.json()
        a, b = both(sides, lambda s: s.client.post(
            f"/api/v1/processing/jobs/{s.ids['job']}/cancel",
            headers=s.headers))
        assert a.status_code == 200 and a.json() == b.json()
        a, b = both(sides, lambda s: s.client.get(
            f"/api/v1/processing/jobs/{s.ids['job']}/status",
            headers=s.headers))
        assert b.json()["status"] == "cancelled"
        assert b.json()["celery_status"] == "REVOKED"
        same(a.json(), b.json())
        a, b = both(sides, lambda s: s.client.post(
            f"/api/v1/processing/jobs/{s.ids['job']}/cancel",
            headers=s.headers))
        assert a.status_code == 409 and a.json() == b.json()
        a, b = both(sides, lambda s: s.client.get(
            f"/api/v1/processing/jobs/{s.ids['job']}", headers=s.headers))
        same(a.json(), b.json())
    finally:
        release.set()
        for s in sides:
            for r in s.ids["blockers"]:
                s.wait(r.id)
            s.queue.tasks.pop(f"_block_{s.pkg}")


def test_session_model_registry(sides):
    mv = {"name": "dbnet-demo", "version": "2", "model_type": "detector",
          "file_path": DET, "config": {"input": 160}}
    a, b = both(sides, lambda s: s.client.post(
        "/api/v1/models", json_body=mv, headers=s.headers))
    assert a.status_code == 201
    same(a.json(), b.json())
    for s, r in zip(sides, (a, b)):
        s.ids["model"] = r.json()["id"]
    a, b = both(sides, lambda s: s.client.post(
        f"/api/v1/models/{s.ids['model']}/activate", headers=s.headers))
    assert b.json()["is_active"] == 1
    same(a.json(), b.json())
    a, b = both(sides, lambda s: s.client.get(
        "/api/v1/models", params={"model_type": "detector"},
        headers=s.headers))
    same(a.json(), b.json())
    a, b = both(sides, lambda s: s.client.post(
        "/api/v1/models/999/activate", headers=s.headers))
    assert a.status_code == 404 and a.json() == b.json()
    a, b = both(sides, lambda s: s.client.post(
        "/api/v1/models", json_body={"name": "x"}, headers=s.headers))
    assert a.status_code == 422 and a.json() == b.json()


def test_session_health_and_metrics(sides):
    a, b = both(sides, lambda s: s.client.get("/health"))
    # the wall clock and the in-memory database's name differ
    bodies = a.json(), b.json()
    for body in bodies:
        assert body.pop("timestamp") > 0 and body["database"].pop("database")
    same(*bodies)
    for path in ("/health/ready", "/health/live"):
        a, b = both(sides, lambda s: s.client.get(path))
        assert a.status_code == 200 and a.json() == b.json()
    a, b = both(sides, lambda s: s.client.get("/health/detailed"))
    ca, cb = a.json()["checks"], b.json()["checks"]
    assert set(ca) == set(cb)
    # queue counters, free disk and memory move between the two calls
    for name in set(ca) - {"accelerator"}:
        assert ca[name]["status"] == cb[name]["status"], name
        assert set(ca[name]) == set(cb[name]), name
    if not torch.cuda.is_available():
        assert cb["accelerator"]["status"] == "unhealthy"
        assert b.json()["status"] == "degraded"
    a, b = both(sides, lambda s: s.client.get("/metrics"))
    assert a.media_type == b.media_type
    ref_families = set(re.findall(r"^# TYPE (\S+) ", a.render().decode(),
                                  re.M))
    port_families = set(re.findall(r"^# TYPE (\S+) ", b.render().decode(),
                                   re.M))
    # the port's own series: how TrOCR chunks were decoded (CUDA graphs
    # or the eager loop), which the reference has no counterpart of
    port_only = {"trocr_decode_chunks_total", "trocr_graph_captures_total"}
    assert port_only <= port_families
    assert port_families - port_only <= ref_families, (
        port_families - port_only - ref_families)


def test_session_delete(sides):
    a, b = both(sides, lambda s: s.client.delete(
        f"/api/v1/videos/{s.ids['video']}", headers=s.headers))
    assert a.status_code == 204
    a, b = both(sides, lambda s: s.client.get(
        f"/api/v1/videos/{s.ids['video']}", headers=s.headers))
    assert a.status_code == 404 and a.json() == b.json()


# -- the port on its own --------------------------------------------------
_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*)?\})? '
    r'(-?[0-9]+\.[0-9]+(e[+-][0-9]+)?|[+-]Inf|NaN)$'
)


def test_metrics_exposition_parses_line_by_line():
    from vtd_tpu_torch.obs import metrics

    reg = metrics.Registry()
    c = metrics.Counter("jobs_total", "Jobs", ["kind"], registry=reg)
    h = metrics.Histogram("lat_seconds", "Latency", ["stage"], registry=reg)
    g = metrics.Gauge("depth", "Depth", registry=reg)
    i = metrics.Info("build", "Build", registry=reg)
    c.labels('a"b\\c\n').inc(2)
    for v in (0.004, 0.3, 20.0):
        h.labels("detect").observe(v)
    g.set(3)
    i.info({"version": "1"})
    lines = metrics.generate_latest(reg).decode().splitlines()
    types = {}
    for ln in lines:
        if ln.startswith("# "):
            kind, name, rest = ln[2:].split(" ", 2)
            assert kind in ("HELP", "TYPE")
            if kind == "TYPE":
                types[name] = rest
            continue
        m = _SAMPLE.match(ln)
        assert m, ln
    assert types == {"jobs_total": "counter", "lat_seconds": "histogram",
                     "depth": "gauge", "build_info": "gauge"}
    text = "\n".join(lines)
    assert 'jobs_total{kind="a\\"b\\\\c\\n"} 2.0' in text
    assert 'lat_seconds_bucket{stage="detect",le="0.005"} 1.0' in text
    assert 'lat_seconds_bucket{stage="detect",le="10.0"} 2.0' in text
    assert 'lat_seconds_bucket{stage="detect",le="+Inf"} 3.0' in text
    assert 'lat_seconds_count{stage="detect"} 3.0' in text
    assert "depth 3.0" in text and 'build_info{version="1"} 1.0' in text
    with pytest.raises(ValueError):
        metrics.Counter("jobs_total", "again", registry=reg)
    # the series of the reference's obs/metrics.py, with its buckets
    from prometheus_client import Histogram as PromHistogram

    assert metrics.DEFAULT_BUCKETS == PromHistogram.DEFAULT_BUCKETS
    full = metrics.generate_latest().decode()
    for ln in full.splitlines():
        assert ln.startswith("# ") or _SAMPLE.match(ln), ln
    import vtd_tpu.obs.metrics as ref_metrics

    for name in ("video_uploads_total", "model_inference_duration_seconds",
                 "recognizer_chunk_occupancy", "celery_tasks_total",
                 "app_info_info"):
        assert f"# TYPE {name} " in full
        assert name.removesuffix("_total") in {
            n.removesuffix("_total")
            for n in ref_metrics.REGISTRY._names_to_collectors
        }


def test_cuda_probe_reports_unhealthy_without_cuda():
    from vtd_tpu_torch.obs.health import HealthCheck

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    out = asyncio.run(HealthCheck().check_accelerator())
    assert out == {"status": "unhealthy", "error": "CUDA is not available",
                   "probe": "cuda"}


def test_serve_exits_nonzero_without_cuda(tmp_path):
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH"))
                           if p)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=path)
    res = subprocess.run(
        [sys.executable, "-m", "vtd_tpu_torch", "serve", "--host",
         "127.0.0.1", "--port", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path, env=env,
    )
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr, res.stderr


@pytest.mark.parametrize("url", ["redis://localhost:6379/0",
                                 "amqp://guest@localhost//"])
def test_non_local_brokers_raise(url, monkeypatch):
    """Schemes that are no broker of the port raise; ``file://`` and
    ``tcp://`` build brokers (tests/test_torch_broker.py)."""
    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.serve import queue

    monkeypatch.setattr(settings, "celery_broker_url", url)
    with pytest.raises(ValueError, match="unsupported"):
        queue._broker_from_settings()
    monkeypatch.setattr(settings, "celery_broker_url", "local://")
    assert queue._broker_from_settings() is None


def test_process_worker_pool_from_settings(monkeypatch):
    """``WORKER_POOL=process`` gives a queue whose tasks run in a spawned
    child (the pool's cases: tests/test_torch_procworker.py)."""
    import torch_proc_tasks
    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.serve import queue

    monkeypatch.setattr(settings, "worker_pool", "process")
    q = queue.TaskQueue(worker_kind=queue._worker_kind_from_settings(),
                        tasks_module="torch_proc_tasks", concurrency=1)
    q.task(name="whoami")(torch_proc_tasks.whoami.fn)
    try:
        assert q.tasks["whoami"].delay().get(timeout=180) != os.getpid()
        assert q.stats()["workers"] == 1
    finally:
        q.shutdown()


@pytest.mark.parametrize("key,value", [("data_parallel_chips", 2)],
                         ids=["data_parallel_chips-2-multi-GPU"])
def test_later_slice_settings_raise(key, value, monkeypatch, clip):
    """``data_parallel_chips = 2``, which raised before the multi-device
    slice, serves a job over a mesh of two CPU entries whose results equal
    the same job served on one device."""
    import torch_video_tasks
    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.serve import tasks

    config = {"confidence_threshold": 0.5, "use_transformer": False}
    rows = []
    try:
        for chips in (0, value):
            monkeypatch.setattr(settings, key, chips)
            tasks.configure_pipeline(**torch_video_tasks.PIPE)
            pipe = tasks.get_pipeline(False)
            assert len(pipe.replicas) == chips
            rows.append(torch_video_tasks.run_on_thread_worker(clip, config)[1])
            pipe.close()
    finally:
        tasks.configure_pipeline()
    one, two = (r["result_data"] for r in rows)
    assert rows[0]["status"] == rows[1]["status"] == "completed"
    assert two["results"] == one["results"]
    assert two["summary"]["total_detections"] == \
        one["summary"]["total_detections"] > 0
