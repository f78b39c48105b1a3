"""The port's span recorder (``vtd_tpu_torch/obs/trace.py``), on the CPU.

Off (no recording, no operator's trace) a span reads no clock and calls
no ``torch.profiler`` code. Recording, it keeps name, thread, parent,
stamps, CPU time and items; a span that opened before ``start()`` is
dropped, and the snapshot's clock pair puts a span on kineto's timeline.
``process_video`` records the layer spans batch by batch, with both
engines, and gives the results it gives with recording off.
"""
import asyncio
import os
import threading
import time
from collections import Counter

import pytest
import torch

from test_torch_serve import write_clip
from vtd_tpu_torch.obs import trace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPE = dict(
    detector_path=os.path.join(REPO, "demo_models2", "dbnet", "best_bf16"),
    batch_size=4, max_dets=16, detector_input_size=160,
    decode_backend="cv2", device="cpu",
)


@pytest.fixture
def recorder():
    trace.start()
    try:
        yield trace
    finally:
        trace.stop()


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read with recording off")


def _no_range(name):
    raise AssertionError(f"record_function({name!r}) with recording off")


def test_off_reads_no_clock_and_calls_no_profiler(monkeypatch):
    monkeypatch.setattr(trace, "time", _NoClock())
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _no_range)
    a = trace.span("vtd.a")
    assert a is trace.span("vtd.b", 7)  # one shared null context
    with a as sp:
        sp.items = 3
        with trace.span("vtd.c"):
            pass
    monkeypatch.undo()
    trace.start()
    trace.stop()
    assert trace.snapshot()["spans"] == []


def _other_thread():
    with trace.span("vtd.other"):
        pass


def test_recording_keeps_nesting_items_threads_and_cpu(recorder):
    with trace.span("vtd.outer", 4) as outer:
        with trace.span("vtd.inner"):
            sum(range(20000))
        outer.items = 5
        th = threading.Thread(target=_other_thread)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        time.sleep(0.01)  # wall time that is no CPU time
    snap = trace.snapshot()
    by = {s.name: (i, s) for i, s in enumerate(snap["spans"])}
    assert set(by) == {"vtd.outer", "vtd.inner", "vtd.other"}
    i_out, out = by["vtd.outer"]
    _, inner = by["vtd.inner"]
    _, other = by["vtd.other"]
    assert out.parent == -1 and inner.parent == i_out
    assert other.parent == -1  # another thread's stack
    assert out.items == 5 and inner.items == 1
    assert out.thread == inner.thread == threading.get_ident()
    assert other.thread != out.thread
    assert out.t0_ns <= inner.t0_ns <= inner.t1_ns <= out.t1_ns
    for s in snap["spans"]:
        assert 0 <= s.cpu_ns <= s.t1_ns - s.t0_ns
    assert out.t1_ns - out.t0_ns - out.cpu_ns >= 5e6  # the sleep
    perf, epoch = snap["clock"]
    assert abs(epoch - perf - (time.time_ns() - time.perf_counter_ns())) < 5e6


def test_a_span_opened_before_start_is_dropped():
    with trace.annotating():  # makes spans open while nothing records
        with trace.span("vtd.early"):
            trace.start()
            try:
                with trace.span("vtd.late"):
                    pass
            finally:
                trace.stop()
    snap = trace.snapshot()
    assert [(s.name, s.parent) for s in snap["spans"]] == [("vtd.late", -1)]
    # and one still open at stop() is dropped too
    trace.start()
    with trace.span("vtd.open_at_stop"):
        trace.stop()
    assert trace.snapshot()["spans"] == []


def test_the_clock_pair_puts_a_span_on_kinetos_timeline(recorder):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            trace.annotating():
        with trace.span("vtd.mapped"):
            time.sleep(0.005)
    snap = trace.snapshot()
    (s,) = snap["spans"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "vtd.mapped"]
    perf, epoch = snap["clock"]
    assert abs(s.t0_ns + epoch - perf - ev.start_ns()) < 1e6
    assert abs(s.t1_ns + epoch - perf
               - (ev.start_ns() + ev.duration_ns())) < 1e6


def _run(pipe, clip, record):
    if not record:
        return asyncio.run(pipe.process_video(clip, "")), None
    trace.start()
    try:
        out = asyncio.run(pipe.process_video(clip, ""))
    finally:
        trace.stop()
    return out, trace.snapshot()


def _check_layers(snap, batches):
    spans = snap["spans"]
    names = Counter(s.name for s in spans)
    for name in ("vtd.dispatch", "vtd.dbnet", "vtd.postprocess",
                 "vtd.collect", "vtd.collect_wait"):
        assert names[name] == batches, (name, names)
    assert names["vtd.job_open"] == names["vtd.job_close"] == 1
    decode = [s for s in spans if s.name == "vtd.decode"]
    # one wait a batch and the wait for the producers' end
    assert sum(s.items > 0 for s in decode) == batches == len(decode) - 1
    assert sum(s.items for s in decode) == 20  # the clip's candidates
    assert names["vtd.decode_read"] >= 20 and names["vtd.decode_prep"] == 20
    assert sum(s.items for s in spans if s.name == "vtd.decode_read") == 60
    for s in spans:
        if s.name in ("vtd.dbnet", "vtd.postprocess"):
            parent = spans[s.parent]
            assert parent.name == "vtd.dispatch" and parent.thread == s.thread
            assert s.items == 4
        if s.name == "vtd.cc_sync":
            assert spans[s.parent].name == "vtd.postprocess"
        if s.name == "vtd.collect_wait":
            assert spans[s.parent].name == "vtd.collect"
    assert names["vtd.cc_sync"] >= batches
    producers = {s.thread for s in spans if s.name == "vtd.decode_read"}
    assert producers.isdisjoint({s.thread for s in decode})
    return spans


def test_process_video_records_the_layers(tmp_path):
    from vtd_tpu_torch.runtime import VideoTextPipeline

    pipe = VideoTextPipeline(
        recognizer_path=os.path.join(REPO, "demo_models2", "crnn",
                                     "crnn_final"),
        use_transformer_ocr=False, **PIPE)
    clip = write_clip(str(tmp_path / "clip.mp4"))
    plain, _ = _run(pipe, clip, False)
    traced, snap = _run(pipe, clip, True)
    assert plain["status"] == traced["status"] == "success"
    assert traced["results"] == plain["results"]
    assert plain["summary"]["total_detections"] > 0
    spans = _check_layers(snap, 5)
    crnn = [s for s in spans if s.name == "vtd.crnn"]
    assert len(crnn) == 5
    assert all(spans[s.parent].name == "vtd.dispatch" for s in crnn)


def test_process_video_records_the_trocr_steps(tmp_path):
    from vtd_tpu_torch.models.trocr import small_config
    from vtd_tpu_torch.runtime import VideoTextPipeline

    cfg = small_config(image_size=32, image_width=64, max_len=6)
    pipe = VideoTextPipeline(
        use_transformer_ocr=True, rec_chunk=4,
        recognizer_kwargs={"transformer_config": cfg}, **PIPE)
    clip = write_clip(str(tmp_path / "clip.mp4"))
    plain, _ = _run(pipe, clip, False)
    traced, snap = _run(pipe, clip, True)
    assert traced["results"] == plain["results"]
    spans = _check_layers(snap, 5)
    chunks = [i for i, s in enumerate(spans) if s.name == "vtd.trocr"]
    steps = [s for s in spans if s.name == "vtd.trocr_step"]
    assert chunks, "no crop reached the recogniser"
    assert len(steps) == cfg.max_len * len(chunks)
    for i in chunks:
        mine = [s for s in steps if s.parent == i]
        assert len(mine) == cfg.max_len
        assert all(s.items == spans[i].items for s in mine)
        assert spans[spans[i].parent].name == "vtd.collect"
