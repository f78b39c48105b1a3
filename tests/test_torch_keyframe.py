"""Keyframe sampling of the port (cv2 gate) against ``vtd_tpu``'s.

On a scene clip of the kind of ``tests/test_keyframe_decode.py``: the
keyframes, the duplicates and the keyframe each duplicate refers to are
the same as the reference's cv2 gate gives (max-gap refresh included),
and ``process_video(sample_mode="keyframe")`` propagates each keyframe's
detections to the candidates it covers as the reference does, also when
half the frames come from the reference's resume file. Results are
compared at the tolerances of
``tests/test_torch_pipeline.py::test_process_video_matches_reference``.
"""
import asyncio
import os

import cv2
import numpy as np
import pytest
import torch

from test_torch_pipeline import (
    SETTINGS, _assert_same_video_result, _reference_pipeline,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "demo_models2", "dbnet", "best_bf16")
CRNN = os.path.join(REPO, "demo_models2", "crnn", "crnn_final")


@pytest.fixture(scope="module")
def scene_video(tmp_path_factory):
    """4-second 320x240 @ 30 fps clip with a hard scene change at 2 s:
    HELLO WORLD on white, then 123 HELLO on gray; 40 candidates at
    10 fps."""
    path = str(tmp_path_factory.mktemp("vid") / "scenes.mp4")
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (320, 240)
    )
    for i in range(120):
        first = i < 60
        frame = np.full((240, 320, 3), 255 if first else 200, np.uint8)
        cv2.putText(frame, "HELLO WORLD" if first else "123 HELLO",
                    (20, 120), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 0), 2)
        writer.write(frame)
    writer.release()
    return path


def _collect(batches):
    kf, dups = [], []
    for b in batches:
        if b.get("frames") is not None:
            n = int(b["valid"].sum())
            kf.extend(int(x) for x in b["frame_numbers"][:n])
        for fn, ts, ref in b.get("dups") or []:
            dups.append((int(fn), float(ts), int(ref)))
    return kf, dups


@pytest.mark.parametrize("max_gap", [None, 3, 1000])
def test_keyframe_candidates_match_reference(scene_video, max_gap):
    from vtd_tpu.video import VideoProcessor as RefProcessor
    from vtd_tpu_torch.video.processor import VideoProcessor

    kw = dict(batch_size=4, target_fps=10.0, sample_mode="keyframe",
              keyframe_max_gap=max_gap)
    want = _collect(RefProcessor().extract_frame_batches(
        scene_video, decode_backend="cv2", **kw))
    got = _collect(VideoProcessor().extract_frame_batches(
        scene_video, decode_backend="cv2", **kw))
    assert got == want
    kf, dups = got
    serial = [i for _, i, _ in VideoProcessor().extract_frames_at_fps(
        scene_video, 10.0)]
    # every stride candidate is a keyframe or a duplicate of one
    assert sorted(kf + [fn for fn, _, _ in dups]) == serial == list(range(40))
    # the gap refresh: a duplicate lies fewer than max_gap candidates
    # after its keyframe (default: 2 s worth at 10 fps)
    gap = max_gap or 20
    assert all(0 < fn - ref <= gap for fn, _, ref in dups)
    assert 2 <= len(kf) <= 40 // min(gap, 40) + 2
    assert {0, 20} <= set(kf)  # the first frame and the scene change


def test_stride_batches_carry_no_dups_native_and_cv2(scene_video):
    """Stride mode ships all 40 candidates and no duplicates at the
    default backend, with cv2 and with the native decoder (which raises
    ``ValueError`` where libav is absent, as the reference's does)."""
    from vtd_tpu_torch.native import video as native_video
    from vtd_tpu_torch.video.processor import VideoProcessor

    vp = VideoProcessor()
    kf, dups = _collect(vp.extract_frame_batches(scene_video, batch_size=4))
    assert kf == list(range(40)) and dups == []
    cv = _collect(vp.extract_frame_batches(scene_video, batch_size=4,
                                           decode_backend="cv2"))
    assert cv == (kf, dups)
    native = vp.extract_frame_batches(scene_video, batch_size=4,
                                      decode_backend="native")
    if native_video.available():
        assert _collect(native) == cv
    else:
        with pytest.raises(ValueError, match="native decode unavailable"):
            next(native)


@pytest.fixture(scope="module")
def pipelines():
    from vtd_tpu_torch.runtime import VideoTextPipeline

    ref = _reference_pipeline(DET, CRNN, **SETTINGS)
    port = VideoTextPipeline(DET, CRNN, device="cpu",
                             recognizer_kwargs={"pad_batch": 32}, **SETTINGS)
    return ref, port


def test_keyframe_propagation_matches_reference(scene_video, pipelines):
    ref, port = pipelines
    want = asyncio.run(ref.process_video(scene_video, "",
                                         sample_mode="keyframe"))
    got = asyncio.run(port.process_video(scene_video, "",
                                         sample_mode="keyframe"))
    _assert_same_video_result(got, want)
    frames = got["results"]
    assert [f["frame_number"] for f in frames] == list(range(40))
    assert [f.get("duplicate_of") for f in frames] == [
        f.get("duplicate_of") for f in want["results"]]
    by_fn = {f["frame_number"]: f for f in frames}
    dups = [f for f in frames if "duplicate_of" in f]
    assert dups
    for f in dups:
        assert f["detections"] == by_fn[f["duplicate_of"]]["detections"]
    assert got["summary"]["total_frames"] == 40
    # the instance default selects the mode too
    port.sample_mode = "keyframe"
    try:
        again = asyncio.run(port.process_video(scene_video, ""))
    finally:
        port.sample_mode = "stride"
    _assert_same_video_result(again, want)


def test_keyframe_resume_from_reference_file(scene_video, pipelines,
                                             tmp_path):
    """The port resumes from the first half of the reference's resume
    file (keyframes and duplicates) and computes the rest."""
    ref, port = pipelines
    ref_file = str(tmp_path / "ref.jsonl")
    want = asyncio.run(ref.process_video(
        scene_video, "", resume_file=ref_file, sample_mode="keyframe"))
    lines = open(ref_file).read().splitlines()
    assert len(lines) == 40
    resume = str(tmp_path / "port.jsonl")
    with open(resume, "w") as fh:
        fh.write("\n".join(lines[:20]) + "\n")
    shipped = []
    orig = port._dispatch_batch

    def counting(frames, **kw):
        shipped.append(int(np.asarray(kw["valid_frames"]).sum()))
        return orig(frames, **kw)

    port._dispatch_batch = counting
    try:
        got = asyncio.run(port.process_video(
            scene_video, "", resume_file=resume, sample_mode="keyframe"))
    finally:
        del port._dispatch_batch
    _assert_same_video_result(got, want)
    assert [f.get("duplicate_of") for f in got["results"]] == [
        f.get("duplicate_of") for f in want["results"]]
    # the restored lines stay, the other 20 frames are appended
    assert len(open(resume).read().splitlines()) == 40
    # only keyframes are shipped, and not all of them again
    n_kf = sum(1 for f in want["results"] if "duplicate_of" not in f)
    assert sum(shipped) < n_kf
