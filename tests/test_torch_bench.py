"""The port's bench (``vtd_tpu_torch/bench.py``) against the repo's
``bench.py``: the clip generator, the JSON line, the CLI without CUDA,
and config 2's recognition against ``vtd_tpu``'s ``TextRecognizer``.

Tolerances: clip frames byte-equal; the JSON lines equal for the same
inputs; config 2's transcripts equal and confidences within 1e-4,
float32 on both sides.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref_bench():
    """The repo's bench.py, imported by path; the JAX settings it changes
    while it is imported are put back."""
    import jax

    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "ref_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


class _Writer:
    """Stand-in for cv2.VideoWriter that keeps the frames it is given."""

    frames: list = []

    def __init__(self, path, fourcc, fps, size):
        self.size = size

    def write(self, frame):
        assert frame.shape[1::-1] == self.size
        _Writer.frames.append(frame.copy())

    def release(self):
        pass


def test_clip_frames_equal_bench_make_clip(ref_bench, monkeypatch):
    import cv2

    from vtd_tpu_torch import bench

    _Writer.frames = []
    monkeypatch.setattr(cv2, "VideoWriter", _Writer)
    ref_bench.make_clip("unused.mp4", seconds=2)
    want = _Writer.frames
    got = list(bench.clip_frames(seconds=2))
    assert len(got) == len(want) == 60
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_emit_lines_equal_bench(ref_bench, monkeypatch, capsys, tmp_path):
    from vtd_tpu_torch import bench

    monkeypatch.setattr(ref_bench, "_REPO", str(tmp_path / "ref"))
    monkeypatch.setattr(bench, "_ARTIFACTS", str(tmp_path / "port"))
    monkeypatch.setenv("VTD_BENCH_TAG", "t")
    lines = {}
    for name, mod in (("ref", ref_bench), ("port", bench)):
        # a metric BASELINE_measured.json has, so vs_measured_ref is set
        mod._emit("crnn_ctc_crops_per_sec", 123.456, "crops/s", 12.3456,
                  json_extra={"agg": "min_of_3", "runs_fps": [1.0, 2.0]},
                  frames=7, elapsed="1.00s")
        mod._emit_failure("multistream_aggregate_fps", "bench_crashed",
                          "x" * 900)
        out = capsys.readouterr()
        lines[name] = ([json.loads(ln) for ln in out.out.splitlines()],
                       out.err)
    assert lines["port"] == lines["ref"]
    emitted, failure = lines["port"][0]
    assert "vs_measured_ref" in emitted
    assert len(failure["detail"]) == 800
    for path in (tmp_path / "ref" / "bench_artifacts" / "t",
                 tmp_path / "port" / "t"):
        rec = json.loads((path / "crnn_ctc_crops_per_sec.json").read_text())
        assert rec.pop("captured_unix") > 0
        assert rec == emitted


def test_bench_without_cuda_fails_naming_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "vtd_tpu_torch.bench", "--config", "3"],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path,
    )
    assert res.returncode != 0
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    assert lines[0]["metric"] == "e2e_720p_ocr_frames_per_sec_per_chip"
    assert lines[0]["error"] == "cuda_unavailable"
    assert lines[0]["value"] == 0.0


def test_config2_recognition_matches_reference():
    import jax.numpy as jnp

    from vtd_tpu.models.crnn import CRNN
    from vtd_tpu.runtime.recognizer import TextRecognizer as RefRecognizer
    from vtd_tpu.train.recognizer_trainer import synthesize_text_lines
    from vtd_tpu_torch import bench

    crops = bench.config2_crops(32)
    images, _ = synthesize_text_lines(32, seed=0)  # as bench.py makes them
    want_crops = [(images[i] * 255).astype(np.uint8) for i in range(32)]
    for g, w in zip(crops, want_crops):
        np.testing.assert_array_equal(g, w)

    ref = RefRecognizer(bench.TRAINED_CRNN, use_transformer=False,
                        pad_batch=128)
    ref.crnn = CRNN(dtype=jnp.float32)
    want = ref.recognize_batch(crops)
    got = bench.config2_recognizer("cpu").recognize_batch(crops)
    assert [g["text"] for g in got] == [w["text"] for w in want]
    assert sum(bool(g["text"]) for g in got) > 16
    np.testing.assert_allclose([g["confidence"] for g in got],
                               [w["confidence"] for w in want], atol=1e-4)
