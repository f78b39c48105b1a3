"""The port's native libav decoder (``vtd_tpu_torch/native/video.py``)
against ``vtd_tpu``'s, built from their own copies of
``video_decode.cpp`` against this host's libav.

Readers give byte-equal frames and equal indices (stride reads, after a
seek, an odd source, the in-decoder keyframe gate and its reset after a
seek); ``extract_frame_batches`` at 'auto' and 'native' gives the
reference's batches byte for byte; ``process_video`` and the engine at
their default backend give the reference's results at the tolerances of
``tests/test_torch_pipeline.py::_assert_same_video_result``. Without
libav, 'auto' is cv2 and 'native' raises as in the reference; with libav
but a source that does not compile, the build raises and nothing falls
back to cv2. Everything skips where the reference's decoder is
unavailable, as ``tests/test_native_video.py`` does.
"""
import asyncio
import logging

import cv2
import numpy as np
import pytest
import torch

from test_torch_keyframe import CRNN, DET, scene_video  # noqa: F401
from test_torch_pipeline import (
    SETTINGS, _assert_same_video_result, _reference_pipeline,
)

torch.set_num_threads(2)

DEFAULTS = {k: v for k, v in SETTINGS.items() if k != "decode_backend"}


def _write(path, w, h, n, fps=30.0):
    """The clip of ``tests/test_native_video.py``: a background that
    brightens by one level a frame, a frame label and a moving disc of a
    random colour."""
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    rng = np.random.default_rng(0)
    for i in range(n):
        frame = np.full((h, w, 3), 40 + i, np.uint8)
        cv2.putText(frame, f"FRAME {i}", (40, h // 2),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.5, (255, 255, 255), 3)
        cv2.circle(frame, (int(100 + 3 * i), 90), 30,
                   tuple(int(c) for c in rng.integers(0, 255, 3)), -1)
        writer.write(frame)
    writer.release()
    return path


@pytest.fixture(scope="module")
def libs():
    """Both decoders, built once; skips where the reference's is
    unavailable."""
    from vtd_tpu.native import video as ref_video
    from vtd_tpu_torch.native import video as port_video

    if not ref_video.available():
        pytest.skip("native video decoder unavailable on this host")
    port_video.build()
    return port_video, ref_video


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """640x360, 90 frames at 30 fps, mp4v."""
    return _write(str(tmp_path_factory.mktemp("nv") / "clip.mp4"),
                  640, 360, 90)


@pytest.fixture(scope="module")
def odd_clip(tmp_path_factory):
    """641x361 (both odd), 30 frames at 30 fps."""
    return _write(str(tmp_path_factory.mktemp("nv") / "odd.mp4"),
                  641, 361, 30)


def _read_all(reader, stride, chunk=8):
    frames, idx = [], []
    while True:
        f, i = reader.read_batch(stride, chunk)
        if len(f) == 0:
            return frames, idx
        frames.append(f)
        idx.append(i)


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["clip", "odd_clip", "scene_video"])
def test_reader_info_matches_reference(libs, request, name):
    port_video, ref_video = libs
    path = request.getfixturevalue(name)
    got = port_video.open_video(path, (64, 64))
    want = ref_video.open_video(path, (64, 64))
    try:
        assert got.fps == want.fps > 0
        assert got.frame_count == want.frame_count > 0
        assert (got.src_w, got.src_h) == (want.src_w, want.src_h)
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize("seek", [None, 60])
@pytest.mark.parametrize("size", [(320, 320), None])
@pytest.mark.parametrize("fmt", ["yuv420", "bgr"])
def test_read_batch_matches_reference(libs, clip, fmt, size, seek):
    port_video, ref_video = libs
    size = size or (640, 360)
    got = port_video.NativeVideoReader(clip, size, fmt)
    want = ref_video.NativeVideoReader(clip, size, fmt)
    if seek:
        got.seek(seek)
        want.seek(seek)
    gf, gi = _read_all(got, 3)
    wf, wi = _read_all(want, 3)
    got.close()
    want.close()
    _assert_same_arrays(gf, wf)
    _assert_same_arrays(gi, wi)
    assert np.concatenate(gi).tolist() == list(range(seek or 0, 90, 3))
    shape = (size[1] * 3 // 2, size[0]) if fmt == "yuv420" else (
        size[1], size[0], 3)
    assert gf[0].shape[1:] == shape


@pytest.mark.parametrize("fmt", ["yuv420", "bgr"])
def test_odd_source_matches_reference(libs, odd_clip, fmt):
    """At the source's size an I420 reader rounds 641x361 down to
    640x360; a BGR one keeps it."""
    port_video, ref_video = libs
    got = port_video.open_video(odd_clip, (641, 361), fmt)
    want = ref_video.open_video(odd_clip, (641, 361), fmt)
    assert (got.out_w, got.out_h) == (want.out_w, want.out_h) == (
        (640, 360) if fmt == "yuv420" else (641, 361))
    gf, gi = _read_all(got, 1)
    wf, wi = _read_all(want, 1)
    got.close()
    want.close()
    _assert_same_arrays(gf, wf)
    _assert_same_arrays(gi, wi)
    assert np.concatenate(gi).tolist() == list(range(30))


@pytest.mark.parametrize("name", ["clip", "scene_video"])
@pytest.mark.parametrize("fmt", ["yuv420", "bgr"])
def test_read_batch_kf_matches_reference(libs, request, name, fmt):
    """Gated reads in chunks of 4 up to source frame 45, a seek back to
    30 (the gate starts again there: frame 30 is kept) and on to the
    end: frames, indices, duplicates and their keyframes equal."""
    port_video, ref_video = libs
    path = request.getfixturevalue(name)

    def run(mod):
        r = mod.NativeVideoReader(path, (320, 176), fmt)
        reads = [r.read_batch_kf(3, 4, 45, kf_diff=4.0, kf_max_gap=5)
                 for _ in range(6)]
        r.seek(30)
        after = r.read_batch_kf(3, 4, kf_diff=4.0, kf_max_gap=5)
        reads.append(after)
        while len(reads[-1][0]) or len(reads[-1][2]):
            reads.append(r.read_batch_kf(3, 4, kf_diff=4.0, kf_max_gap=5))
        r.close()
        return reads

    got, want = run(port_video), run(ref_video)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_arrays(g, w)
    dups = np.concatenate([g[2] for g in got])
    assert len(dups) > 0  # the gate kept some candidates back
    assert got[6][1][0] == 30  # reset after the seek


def _batch_key(b):
    if b["frames"] is None:
        return (1, b["dups"][0][0])
    return (0, int(b["frame_numbers"][0]))


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("mode", ["stride", "keyframe"])
@pytest.mark.parametrize("backend", ["auto", "native"])
def test_extract_frame_batches_matches_reference(libs, clip, backend, mode,
                                                 workers):
    from vtd_tpu.video import VideoProcessor as RefProcessor
    from vtd_tpu_torch.video.processor import VideoProcessor

    kw = dict(batch_size=4, target_fps=10.0, resize_to=320,
              pixel_format="yuv420", sample_mode=mode,
              decode_workers=workers, decode_backend=backend)
    # with two workers the segments' batches interleave in any order
    got = sorted(VideoProcessor().extract_frame_batches(clip, **kw),
                 key=_batch_key)
    want = sorted(RefProcessor().extract_frame_batches(clip, **kw),
                  key=_batch_key)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if w["frames"] is None:
            assert g["frames"] is None
        else:
            assert g["frames"].shape == w["frames"].shape == (4, 480, 320)
            assert np.array_equal(g["frames"], w["frames"])
            for key in ("frame_numbers", "timestamps", "valid"):
                assert np.array_equal(g[key], w[key]), key
            assert g["orig_size"] == w["orig_size"] == (360, 640)
            assert g["pixel_format"] == w["pixel_format"]
        assert g["dups"] == w["dups"]
    if mode == "keyframe":
        assert any(g["dups"] for g in got)


@pytest.fixture(scope="module")
def pipelines(libs):
    """Both pipelines at ``SETTINGS`` without ``decode_backend``."""
    from vtd_tpu_torch.runtime import VideoTextPipeline

    ref = _reference_pipeline(DET, CRNN, **DEFAULTS)
    port = VideoTextPipeline(DET, CRNN, device="cpu",
                             recognizer_kwargs={"pad_batch": 32}, **DEFAULTS)
    assert port.decode_backend == ref.decode_backend == "auto"
    return ref, port


@pytest.mark.parametrize("mode", ["stride", "keyframe"])
def test_process_video_at_defaults_matches_reference(scene_video, pipelines,
                                                     mode):
    ref, port = pipelines
    want = asyncio.run(ref.process_video(scene_video, "", sample_mode=mode))
    got = asyncio.run(port.process_video(scene_video, "", sample_mode=mode))
    _assert_same_video_result(got, want)
    assert [f.get("duplicate_of") for f in got["results"]] == [
        f.get("duplicate_of") for f in want["results"]]


def test_engine_at_default_backend_matches_reference(scene_video, pipelines):
    from vtd_tpu.runtime.engine import InferenceEngine as RefEngine
    from vtd_tpu_torch.runtime import InferenceEngine

    ref, port = pipelines
    ref_engine, engine = RefEngine(pipeline=ref), InferenceEngine(
        pipeline=port)
    try:
        want = ref_engine.process_videos([scene_video])[scene_video]
        got = engine.process_videos([scene_video])[scene_video]
    finally:
        ref_engine.close()
        engine.close()
    _assert_same_video_result(got, want)


@pytest.mark.parametrize("mode", ["stride", "keyframe"])
def test_without_libav_auto_is_cv2_and_native_raises(libs, clip, monkeypatch,
                                                     mode):
    from vtd_tpu_torch.video.processor import VideoProcessor

    port_video, _ = libs
    monkeypatch.setattr(port_video, "available", lambda: False)
    kw = dict(batch_size=4, target_fps=10.0, resize_to=320,
              pixel_format="yuv420", sample_mode=mode)
    vp = VideoProcessor()
    auto = list(vp.extract_frame_batches(clip, **kw))
    cv = list(vp.extract_frame_batches(clip, decode_backend="cv2", **kw))
    assert len(auto) == len(cv) > 0
    for a, c in zip(auto, cv):
        assert set(a) == set(c)
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert np.array_equal(a[key], c[key]), key
            else:
                assert a[key] == c[key], key
    with pytest.raises(ValueError,
                       match=f"native decode unavailable for {clip}"):
        next(vp.extract_frame_batches(clip, decode_backend="native", **kw))


def test_failed_build_raises_and_never_falls_back(libs, clip, monkeypatch,
                                                  tmp_path):
    from vtd_tpu_torch.video.processor import VideoProcessor

    port_video, _ = libs
    bad = tmp_path / "video_decode.cpp"
    bad.write_text("int vtd_vd_open( { this does not compile\n")
    monkeypatch.setattr(port_video, "SRC", bad)
    monkeypatch.setattr(port_video, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_video, "_lib", None)
    assert port_video.libav_missing() is None  # the header probe passes
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: "):
        port_video.build()
    assert not list((tmp_path / "build").glob("*"))  # nothing left behind
    for backend in ("auto", "native"):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            next(VideoProcessor().extract_frame_batches(
                clip, decode_backend=backend))


def test_absent_headers_are_named_once_at_info(libs, monkeypatch, tmp_path,
                                               caplog):
    port_video, _ = libs
    monkeypatch.setattr(port_video, "AV_HEADERS",
                        ("libavcodec/avcodec.h", "libav_absent/none.h"))
    monkeypatch.setattr(port_video, "_probed", False)
    monkeypatch.setattr(port_video, "_missing", None)
    monkeypatch.setattr(port_video, "_lib", None)
    monkeypatch.setattr(port_video, "BUILD_DIR", tmp_path / "build")
    with caplog.at_level(logging.INFO, logger=port_video.__name__):
        assert port_video.available() is False
        assert port_video.available() is False
        assert port_video.open_video("any.mp4", (16, 16)) is None
    records = [r for r in caplog.records if r.name == port_video.__name__]
    assert len(records) == 1 and records[0].levelno == logging.INFO
    assert "libav_absent/none.h" in records[0].getMessage()
    assert "libavcodec/avcodec.h" not in records[0].getMessage()
    with pytest.raises(RuntimeError, match="libav_absent/none.h"):
        port_video.build()
