"""The ``torch.profiler`` trace behind ``profile_dir`` and
``PROFILE_TRACE_DIR``, on the CPU.

``VideoTextPipeline(profile_dir=...)`` writes one Chrome trace a
``process_video`` call, holding the CPU ops of the dispatcher thread that
launches the device work, and its results equal those of the same call
without it; the port's spans (``obs/trace.py``) are ranges in it. With
``PROFILE_TRACE_DIR`` set, a service job completes and leaves its trace.
(On the card the trace also names the kernels: ``chip_smoke.py --phases
fleet``.)
"""
import asyncio
import glob
import json
import os

import pytest
import torch

from test_torch_serve import write_clip

torch.set_num_threads(2)


@pytest.fixture
def video_tasks():
    """``tests/torch_video_tasks.py`` (its import configures the
    service's pipelines), unconfigured again afterwards."""
    import torch_video_tasks
    from vtd_tpu_torch.serve import tasks

    tasks.configure_pipeline(**torch_video_tasks.PIPE)
    try:
        yield torch_video_tasks
    finally:
        tasks.configure_pipeline()


def _trace(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    return ops, {e["tid"] for e in ops}


def test_pipeline_trace_and_unchanged_results(tmp_path, video_tasks):
    from vtd_tpu_torch.runtime.pipeline import VideoTextPipeline

    pipe = dict(video_tasks.PIPE, use_transformer_ocr=False)
    clip = write_clip(str(tmp_path / "clip.mp4"))
    trace_dir = str(tmp_path / "trace")
    traced = VideoTextPipeline(profile_dir=trace_dir, **pipe)
    plain = VideoTextPipeline(**pipe)
    a = asyncio.run(traced.process_video(clip, ""))
    b = asyncio.run(plain.process_video(clip, ""))
    assert a["status"] == b["status"] == "success"
    assert a["results"] == b["results"]
    assert a["summary"]["total_detections"] > 0
    (path,) = glob.glob(os.path.join(trace_dir, "process_video-*.json"))
    assert os.path.basename(path).startswith(
        f"process_video-{os.getpid()}-")
    ops, threads = _trace(path)
    names = {e["name"] for e in ops}
    # the DBNet's convolutions run on the dispatcher thread, the collect
    # loop's host work on this one: both are in the trace
    assert {"aten::conv2d", "aten::sort"} <= names, sorted(names)[:40]
    assert len(threads) >= 2
    # a second call writes a second trace
    asyncio.run(traced.process_video(clip, ""))
    assert len(glob.glob(os.path.join(trace_dir, "*.json"))) == 2


def test_pipeline_trace_holds_the_spans(tmp_path, video_tasks):
    """The spans of ``obs/trace.py`` are ranges of the ``profile_dir``
    trace, on the thread that ran them, and only while it runs."""
    from vtd_tpu_torch.obs import trace
    from vtd_tpu_torch.runtime.pipeline import VideoTextPipeline

    pipe = dict(video_tasks.PIPE, use_transformer_ocr=False)
    clip = write_clip(str(tmp_path / "clip.mp4"))
    trace_dir = str(tmp_path / "trace")
    asyncio.run(VideoTextPipeline(profile_dir=trace_dir, **pipe)
                .process_video(clip, ""))
    (path,) = glob.glob(os.path.join(trace_dir, "process_video-*.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [e for e in events if e.get("name", "").startswith("vtd.")]
    names = {e["name"] for e in ranges}
    assert {"vtd.dispatch", "vtd.dbnet", "vtd.postprocess", "vtd.crnn",
            "vtd.collect", "vtd.decode", "vtd.decode_read"} <= names, names
    tid = {e["name"]: e["tid"] for e in ranges}
    assert tid["vtd.dispatch"] == tid["vtd.dbnet"] != tid["vtd.collect"]
    assert trace.span("vtd.after") is trace.span("vtd.after")  # off again


def test_profile_trace_dir_in_the_service(tmp_path, monkeypatch,
                                         video_tasks):
    """``get_pipeline`` hands ``PROFILE_TRACE_DIR`` to the pipeline as
    the reference does; a job on the thread worker completes and its
    trace is there."""
    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.serve import tasks

    trace_dir = str(tmp_path / "trace")
    for key, sub in (("temp_dir", "temp"), ("output_dir", "out"),
                     ("model_path", "models")):
        monkeypatch.setattr(settings, key, str(tmp_path / sub))
    monkeypatch.setattr(settings, "profile_trace_dir", trace_dir)
    clip = write_clip(str(tmp_path / "clip.mp4"))
    assert tasks.get_pipeline(False).profile_dir == trace_dir
    ret, row = video_tasks.run_on_thread_worker(
        clip, {"use_transformer": False})
    assert row["status"] == "completed" and ret["status"] == "success"
    (path,) = glob.glob(os.path.join(trace_dir, "process_video-*.json"))
    assert os.path.getsize(path) > 0 and _trace(path)[0]
