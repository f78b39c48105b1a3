"""The port's host API against ``vtd_tpu``'s on the same seeded inputs:
the result schemas, ``letterbox_geometry``, ``ImageProcessor``,
``AnnotationProcessor``, ``VideoProcessor.extract_single_frame``,
``native_available``, ``start_metrics_server`` and the names each
sub-package exports. Arrays must be byte-equal and ``to_dict()`` outputs
equal; these are host numpy/cv2 functions on both sides.
"""
import importlib
import os
import subprocess
import sys
import urllib.request

import cv2
import numpy as np
import pytest
import torch

import vtd_tpu.core.schemas as ref_schemas
import vtd_tpu.video.processor as ref_video
import vtd_tpu_torch.core.schemas as port_schemas
import vtd_tpu_torch.video.processor as port_video

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _region(rng, text):
    return dict(
        bbox=[int(v) for v in rng.integers(0, 640, 4)], text=text,
        detection_confidence=float(rng.random()),
        recognition_confidence=np.float32(rng.random()),
        polygon=[[np.int64(x), np.int64(y)]
                 for x, y in rng.integers(0, 640, (4, 2))],
    )


def _schema_cases():
    rng = np.random.default_rng(0)
    r1, r2 = _region(rng, "HELLO"), _region(rng, " 123 ")
    det = dict(bbox=np.arange(4), confidence=np.float32(0.75),
               polygon=rng.integers(0, 99, (4, 2)).tolist())
    summary = dict(total_frames=3, frames_with_text=2, total_detections=2,
                   unique_texts=2, detected_texts=["123", "HELLO"],
                   avg_detection_confidence=np.float64(0.5),
                   avg_recognition_confidence=0.25,
                   processing_time_seconds=1.5, fps_processed=2)
    return [
        ("Detection", lambda m: m.Detection(**det)),
        ("RecognizedRegion", lambda m: m.RecognizedRegion(**r1)),
        ("FrameResult", lambda m: m.FrameResult(
            np.int64(7), np.float32(0.7),
            [m.RecognizedRegion(**r1), m.RecognizedRegion(**r2)])),
        ("PipelineSummary", lambda m: m.PipelineSummary(**summary)),
        ("VideoResult", lambda m: m.VideoResult(
            "success", [m.FrameResult(0, 0.0, [m.RecognizedRegion(**r2)])],
            summary, {"fps": 30.0})),
        ("VideoResult-failed", lambda m: m.VideoResult(
            "failed", [], error="Cannot open video")),
    ]


@pytest.mark.parametrize("name,build", _schema_cases(),
                         ids=[c[0] for c in _schema_cases()])
def test_schemas_to_dict_equal(name, build):
    ours, ref = build(port_schemas).to_dict(), build(ref_schemas).to_dict()
    assert ours == ref
    assert repr(ours) == repr(ref)  # the same types, not only equal values


def _images():
    rng = np.random.default_rng(3)
    return {
        "colour": rng.integers(0, 256, (37, 91, 3), np.uint8),
        "grey": rng.integers(0, 256, (64, 40), np.uint8),
        "tall": rng.integers(0, 256, (120, 33, 3), np.uint8),
    }


@pytest.mark.parametrize("shape,target", [
    ((360, 640), 640), ((640, 360), 640), ((37, 91), 96), ((1, 999), 64)])
def test_letterbox_geometry_equal(shape, target):
    assert port_video.letterbox_geometry(*shape, target) == \
        ref_video.letterbox_geometry(*shape, target)


@pytest.mark.parametrize("method,args", [
    ("resize_with_aspect_ratio", ("colour", 64)),
    ("resize_with_aspect_ratio", ("tall", 48)),
    ("enhance_text_regions", ("colour",)),
    ("enhance_text_regions", ("grey",)),
    ("enhance_text_regions", ("two_channel",)),  # cv2 refuses: the input back
    ("crop_text_region", ("colour", [10, 5, 40, 30])),
    ("crop_text_region", ("colour", [-20, -9, 200, 70], 7)),  # past the border
    ("crop_text_region", ("grey", [0, 0, 3], 2)),  # a bad box: the input back
    ("normalize_image", ("colour",)),
    ("denormalize_image", ("normalized",)),
])
def test_image_processor_equal(method, args):
    images = _images()
    images["two_channel"] = images["colour"][..., :2].copy()
    images["normalized"] = images["colour"] / np.float32(255.0)
    name, *rest = args
    got = getattr(port_video.ImageProcessor, method)(images[name], *rest)
    want = getattr(ref_video.ImageProcessor, method)(images[name], *rest)
    if method == "resize_with_aspect_ratio":
        assert got[1] == want[1]
        got, want = got[0], want[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _boxes(rng, n, h, w):
    x1 = rng.integers(0, w - 8, n)
    y1 = rng.integers(0, h - 8, n)
    return np.stack([x1, y1, x1 + rng.integers(4, 40, n),
                     y1 + rng.integers(4, 30, n)], 1).tolist()


@pytest.mark.parametrize("n_boxes", [0, 1, 7])
def test_annotation_maps_equal(n_boxes):
    rng = np.random.default_rng(n_boxes)
    boxes = _boxes(rng, n_boxes, 80, 120) if n_boxes else []
    A, R = port_video.AnnotationProcessor, ref_video.AnnotationProcessor
    prob = A.create_probability_map((80, 120), boxes)
    ref_prob = R.create_probability_map((80, 120), boxes)
    assert prob.dtype == ref_prob.dtype
    assert prob.tobytes() == ref_prob.tobytes()
    for ratio in (0.4, 0.25):
        t = A.create_threshold_map(prob, ratio)
        assert t.tobytes() == R.create_threshold_map(ref_prob, ratio).tobytes()
    poly = rng.normal(size=(6, 2)) * 30
    assert A._shrink_polygon(poly, 0.4).tobytes() == \
        R._shrink_polygon(poly, 0.4).tobytes()


def test_device_label_maps_match_host_annotation_processor():
    """The port's counterpart of ``tests/test_train.py``'s label test:
    ``train/labels.make_maps`` against the port's own host maps."""
    from vtd_tpu_torch.train.labels import make_maps
    from vtd_tpu_torch.video import AnnotationProcessor

    boxes = np.array([[10, 10, 50, 30], [60, 40, 100, 60]], np.float32)
    valid = np.array([True, True])
    prob, thresh = make_maps(torch.from_numpy(boxes),
                             torch.from_numpy(valid), 80, 120)
    ref_prob = AnnotationProcessor.create_probability_map(
        (80, 120), boxes.astype(int).tolist())
    np.testing.assert_array_equal(prob.numpy(), ref_prob)
    t = thresh.numpy()
    assert t.sum() > 0
    assert (t <= ref_prob).all()
    assert t.sum() < ref_prob.sum()


def _write_clip(path, n=12):
    rng = np.random.default_rng(5)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (96, 64))
    for _ in range(n):
        writer.write(rng.integers(0, 256, (64, 96, 3), np.uint8))
    writer.release()
    return path


def test_extract_single_frame_equal(tmp_path):
    clip = _write_clip(str(tmp_path / "clip.mp4"))
    port, ref = port_video.VideoProcessor(), ref_video.VideoProcessor()
    for i in (0, 5, 11):
        got, want = port.extract_single_frame(clip, i), \
            ref.extract_single_frame(clip, i)
        assert got is not None and got.shape == (64, 96, 3)
        assert got.tobytes() == want.tobytes()
    for path, i in ((clip, 12), (clip, 500), (str(tmp_path / "none.mp4"), 0)):
        assert port.extract_single_frame(path, i) is None
        assert ref.extract_single_frame(path, i) is None


def test_native_available(monkeypatch, tmp_path):
    """A bool, never an exception: True where g++ builds the beam
    library, False with g++ hidden and nothing built."""
    from vtd_tpu_torch import native

    import shutil

    assert native.native_available() is (shutil.which("g++") is not None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.native_available() is False
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.ctc_beam_decode(np.zeros((1, 4, 3), np.float32))


def test_start_metrics_server_serves_the_registry():
    from vtd_tpu_torch.obs import metrics

    metrics.text_detections_total.labels("hostapi-test").inc(3)
    server = metrics.start_metrics_server(0, "127.0.0.1")
    try:
        port = server.server_address[1]
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(f"http://127.0.0.1:{port}/metrics",
                         timeout=30) as resp:
            assert resp.headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
            body = resp.read()
        assert body == metrics.generate_latest()
        assert b'text_detections_total{model_type="hostapi-test"} 3.0' in body
        # a taken port: a warning, no exception
        assert metrics.start_metrics_server(port, "127.0.0.1") is None
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("package", ["core", "models", "train", "video"])
def test_every_reference_export_imports_from_the_port(package):
    ref = importlib.import_module(f"vtd_tpu.{package}")
    port = importlib.import_module(f"vtd_tpu_torch.{package}")
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert not missing
    assert sorted(port.__all__) == sorted(ref.__all__)


def test_core_device_does_not_build_settings():
    code = ("import sys, vtd_tpu_torch.core.device, vtd_tpu_torch.core; "
            "sys.exit('vtd_tpu_torch.core.config' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    from vtd_tpu_torch import core
    from vtd_tpu_torch.core import config

    assert core.settings is config.settings
    assert core.Settings is config.Settings
