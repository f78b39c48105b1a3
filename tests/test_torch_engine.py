"""The port's multi-stream ``InferenceEngine`` against the pipeline it
drives: every Future equals ``process_batch`` on the same frames, streams
of different resolutions never share a batch, and ``process_videos``
equals ``process_video`` per clip. Seeded narrow pipeline on the CPU
(detector input 160, batch 4, 16 slots): results compared exactly.
"""
import asyncio

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

BATCH = 4


@pytest.fixture(scope="module")
def pipe():
    from vtd_tpu_torch.runtime import VideoTextPipeline

    return VideoTextPipeline(
        device="cpu", use_transformer_ocr=False, batch_size=BATCH,
        max_dets=16, detector_input_size=160,
        max_box_frac=1.0, confidence_threshold=0.3, transfer_format="yuv420",
        decode_backend="cv2",
    )


def _frames(seed, n, h=120, w=160):
    """BGR frames, each tagged with its stream and index in pixel (0, 0)."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    f[:, 0, 0, 0] = seed
    f[:, 0, 0, 1] = np.arange(n)
    return f


def test_submit_batch_equals_process_batch(pipe):
    from vtd_tpu_torch.runtime import InferenceEngine

    streams = [_frames(s, 2 * BATCH, h=120 + 40 * s) for s in range(3)]
    masks = [np.ones(BATCH, bool), np.array([True, True, False, False])]
    engine = InferenceEngine(pipeline=pipe)
    futs = [
        [engine.submit_batch(s[k * BATCH:(k + 1) * BATCH], masks[k],
                             orig_size=(2 * s.shape[1], 2 * s.shape[2]))
         for k in range(2)]
        for s in streams
    ]
    got = [[f.result(timeout=120) for f in fs] for fs in futs]
    engine.close()
    assert engine.batches_dispatched == 6
    for s, fs in zip(streams, got):
        for k, per_frame in enumerate(fs):
            want = pipe.process_batch(
                s[k * BATCH:(k + 1) * BATCH], masks[k],
                orig_size=(2 * s.shape[1], 2 * s.shape[2]))
            assert per_frame == want
    assert sum(len(d) for fs in got for b in fs for d in b) > 0


def test_submit_frame_equals_process_batch(pipe):
    """Six frames: one full batch, then a partial one padded with its
    last frame once ``max_wait_ms`` passes."""
    from vtd_tpu_torch.runtime import InferenceEngine

    frames = _frames(7, BATCH + 2)
    engine = InferenceEngine(pipeline=pipe, max_wait_ms=500)
    futs = [engine.submit_frame(f, orig_size=(240, 320)) for f in frames]
    got = [f.result(timeout=120) for f in futs]
    engine.close()
    assert engine.batches_dispatched == 2
    want = pipe.process_batch(frames[:BATCH], np.ones(BATCH, bool),
                              orig_size=(240, 320))
    tail = np.concatenate([frames[BATCH:], frames[-1:].repeat(2, 0)])
    want += pipe.process_batch(tail, np.array([True, True, False, False]),
                               orig_size=(240, 320))[:2]
    assert got == want


def test_mixed_resolutions_never_share_a_batch(pipe, monkeypatch):
    """Frames of two shapes and of two source sizes, interleaved: each
    dispatched batch holds one (shape, orig_size) key, and every Future
    equals process_batch on the batch that carried it."""
    from vtd_tpu_torch.runtime import InferenceEngine

    seen = []
    dispatch = pipe.dispatch_batch

    def spy(frames, **kw):
        seen.append((frames.copy(), kw["valid_frames"].copy()))
        return dispatch(frames, **kw)

    monkeypatch.setattr(pipe, "dispatch_batch", spy)
    keyed = [
        (_frames(1, 5), (240, 320)),
        (_frames(2, 3), (480, 640)),  # same shape, another source size
        (_frames(3, 6, h=96, w=128), (96, 128)),
    ]
    engine = InferenceEngine(pipeline=pipe, max_wait_ms=1000)
    futs = {}
    for i in range(6):
        for frames, orig in keyed:
            if i < len(frames):
                futs[(frames[i, 0, 0, 0], i)] = (
                    engine.submit_frame(frames[i], orig_size=orig), orig)
    got = {k: (f.result(timeout=120), orig) for k, (f, orig) in futs.items()}
    engine.close()
    assert len(seen) >= 5  # at least 2 + 1 + 2 batches
    for frames, valid in seen:
        tags = {int(t) for t in frames[valid, 0, 0, 0]}
        assert len(tags) == 1, "a batch mixed two streams"
        orig = got[(frames[0, 0, 0, 0], int(frames[0, 0, 0, 1]))][1]
        want = pipe.process_batch(frames, valid, orig_size=orig)
        for j in np.nonzero(valid)[0]:
            key = (frames[j, 0, 0, 0], int(frames[j, 0, 0, 1]))
            assert got[key][0] == want[j]


def test_raw_frames_are_downscaled_on_the_host(pipe, monkeypatch):
    import cv2

    from vtd_tpu_torch.runtime import InferenceEngine

    monkeypatch.setattr(pipe, "host_downscale", 96)
    frames = _frames(4, BATCH)
    engine = InferenceEngine(pipeline=pipe, max_wait_ms=500)
    got = [f.result(timeout=120) for f in
           [engine.submit_frame(f) for f in frames]]
    engine.close()
    small = np.stack([cv2.resize(f, (96, 96), interpolation=cv2.INTER_LINEAR)
                      for f in frames])
    assert got == pipe.process_batch(small, np.ones(BATCH, bool),
                                     orig_size=(120, 160))


def _clip(path, w, h, n=20):
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                             (w, h))
    rng = np.random.default_rng(w)
    for i in range(n):
        frame = np.full((h, w, 3), 255, np.uint8)
        frame[h // 3:h // 2, w // 8:w // 2] = rng.integers(0, 80)
        cv2.putText(frame, f"T{i}", (10, h - 10), cv2.FONT_HERSHEY_SIMPLEX,
                    0.6, (0, 0, 0), 2)
        writer.write(frame)
    writer.release()


def test_process_videos_equals_process_video(pipe, tmp_path):
    from vtd_tpu_torch.runtime import InferenceEngine

    paths = [str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")]
    _clip(paths[0], 320, 240)
    _clip(paths[1], 256, 144, n=35)
    engine = InferenceEngine(pipeline=pipe)
    got = engine.process_videos(paths)
    engine.close()
    assert sorted(got) == sorted(paths)
    for path in paths:
        want = asyncio.run(pipe.process_video(path))
        g = got[path]
        assert g["status"] == want["status"] == "success"
        assert g["video_info"] == want["video_info"]
        assert g["results"] == want["results"]
        for key in ("total_frames", "frames_with_text", "total_detections",
                    "unique_texts", "detected_texts"):
            assert g["summary"][key] == want["summary"][key], key
    assert got[paths[1]]["summary"]["total_frames"] == 12  # 35 at 30 fps


def test_process_videos_raises_on_a_bad_path(pipe, tmp_path):
    from vtd_tpu_torch.runtime import InferenceEngine

    engine = InferenceEngine(pipeline=pipe)
    try:
        with pytest.raises(ValueError, match="Cannot open video"):
            engine.process_videos([str(tmp_path / "absent.mp4")])
    finally:
        engine.close()


def test_closed_engine_fails_new_futures(pipe):
    from vtd_tpu_torch.runtime import InferenceEngine

    engine = InferenceEngine(pipeline=pipe)
    engine.close()
    for fut in (engine.submit_frame(_frames(0, 1)[0]),
                engine.submit_batch(_frames(0, BATCH), np.ones(BATCH, bool))):
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=5)


def test_engine_builds_its_pipeline_on_the_card_by_default():
    from vtd_tpu_torch.runtime import InferenceEngine, VideoTextPipeline

    engine = InferenceEngine(device="cpu", use_transformer_ocr=False,
                             batch_size=2, detector_input_size=160)
    try:
        assert isinstance(engine.pipeline, VideoTextPipeline)
        assert engine.batch_size == 2
    finally:
        engine.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine(batch_size=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's pipeline runs there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_engine_matches_process_batch(cuda_device):
    from vtd_tpu_torch.ops.cc_kernels import segmented_cc_round
    from vtd_tpu_torch.runtime import InferenceEngine, VideoTextPipeline

    pipe = VideoTextPipeline(
        use_transformer_ocr=False, batch_size=BATCH, max_dets=16,
        detector_input_size=160, max_box_frac=1.0, confidence_threshold=0.3,
    )
    assert pipe.device.type == "cuda"
    streams = [_frames(s, BATCH, h=120 + 40 * s) for s in range(3)]
    single = _frames(9, BATCH)
    want = [pipe.process_batch(s, np.ones(BATCH, bool)) for s in streams]
    want_single = pipe.process_batch(single, np.ones(BATCH, bool),
                                     orig_size=(120, 160))
    before = segmented_cc_round.launches
    engine = InferenceEngine(pipeline=pipe, max_wait_ms=500)
    single_futs = [engine.submit_frame(f, orig_size=(120, 160))
                   for f in single]
    futs = [engine.submit_batch(s, np.ones(BATCH, bool)) for s in streams]
    got = [f.result(timeout=300) for f in futs]
    got_single = [f.result(timeout=300) for f in single_futs]
    engine.close()
    assert got == want and got_single == want_single
    assert segmented_cc_round.launches - before >= 3 * 4
