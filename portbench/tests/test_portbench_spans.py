"""CPU tests of the span readers (``metrics/<name>.py`` over
``ctx["program"]``, the program's span snapshot) and of ``spans_run.py``:
each reader on a synthetic context, the sub-window left out, nothing to
read where the program records nothing, the existing readers unmoved by
the new context keys, and a tiny cell run end to end with the recorder
on."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from collections import namedtuple

import pytest

from .conftest_tiny import REPO, make_root

S = namedtuple("S", "name thread parent t0_ns t1_ns cpu_ns items")
MS = 1_000_000
NEW = ("dispatch_cpu_ms", "postprocess_sync_ms", "dbnet_host_ms",
       "collect_wait_ms", "decode_busy_ms", "trocr_step_host_ms",
       "idle_unexplained_share")
OLD = ("decode_ms", "dispatch_ms", "dbnet_ms", "postprocess_ms",
       "postprocess_host_ms", "segmented_cc_roofline", "crnn_ms",
       "trocr_ms_per_crop", "trocr_host_ms", "device_idle_share", "mfu",
       "batch_occupancy")


def read(name, ctx):
    from importlib import import_module

    return import_module(f"portbench.metrics.{name}").read(ctx)


def _batch(t, thread=1):
    """One batch's spans from ``t`` ms: a 100 ms dispatch (60 ms on the
    CPU) holding a 20 ms DBNet and a 40 ms postprocess with two waits of
    1 and 2 ms, then a 10 ms collect holding a 4 ms wait, on another
    thread; indices relative to the batch's first span."""
    return [
        S("vtd.dispatch", thread, -1, t * MS, (t + 100) * MS, 60 * MS, 16),
        S("vtd.dbnet", thread, 0, t * MS, (t + 20) * MS, 18 * MS, 16),
        S("vtd.postprocess", thread, 0, (t + 20) * MS, (t + 60) * MS, 30 * MS, 16),
        S("vtd.cc_sync", thread, 2, (t + 30) * MS, (t + 31) * MS, 0, 1),
        S("vtd.cc_sync", thread, 2, (t + 40) * MS, (t + 42) * MS, 0, 1),
        S("vtd.collect", 2, -1, (t + 100) * MS, (t + 110) * MS, 5 * MS, 16),
        S("vtd.collect_wait", 2, 5, (t + 101) * MS, (t + 105) * MS, 0, 1),
    ]


def _program(starts=(0, 200, 400)):
    spans = []
    for t in starts:
        base = len(spans)
        spans += [s._replace(parent=s.parent + base if s.parent >= 0 else -1)
                  for s in _batch(t)]
    # the producer: 30 ms of reads and 10 of prep a batch; the consumer's
    # waits, one a batch and the end's
    for t in starts:
        spans += [S("vtd.decode_read", 3, -1, (t + 110) * MS, (t + 140) * MS, 9 * MS, 48),
                  S("vtd.decode_prep", 3, -1, (t + 140) * MS, (t + 150) * MS, 8 * MS, 1),
                  S("vtd.decode", 1, -1, (t + 150) * MS, (t + 151) * MS, 0, 16)]
    spans.append(S("vtd.decode", 1, -1, 900 * MS, 901 * MS, 0, 0))
    return {"spans": spans, "clock": (0, 10**18)}


def test_each_span_reader_on_a_synthetic_context():
    ctx = {"program": _program(), "sub_t0": None, "sub_t1": None}
    assert read("dispatch_cpu_ms", ctx) == pytest.approx(60)
    assert read("postprocess_sync_ms", ctx) == pytest.approx(3)
    assert read("dbnet_host_ms", ctx) == pytest.approx(20)
    assert read("collect_wait_ms", ctx) == pytest.approx(4)
    assert read("decode_busy_ms", ctx) == pytest.approx(40)
    assert read("trocr_step_host_ms", ctx) is None  # no TrOCR here
    steps = [S("vtd.trocr_step", 1, -1, i * 15 * MS, (i * 15 + 12) * MS, 0, 16)
             for i in range(50)]
    assert read("trocr_step_host_ms",
                {"program": {"spans": steps, "clock": (0, 0)}}) == pytest.approx(12)


def test_the_sub_window_is_left_out():
    # the second batch (200-360 ms) overlaps a sub-window at 0.25-0.30 s
    ctx = {"program": _program((0, 200, 400)), "sub_t0": 0.25, "sub_t1": 0.30}
    prog = ctx["program"]["spans"]
    prog[7] = prog[7]._replace(cpu_ns=90 * MS)  # the second dispatch
    assert read("dispatch_cpu_ms", ctx) == pytest.approx(60)
    assert read("dispatch_cpu_ms", dict(ctx, sub_t0=None, sub_t1=None)) \
        == pytest.approx(70)


def test_idle_unexplained_share_reads_the_gaps_no_span_covers():
    # kineto's clock is 1e18 ns ahead; the sub-window is 0-1000 ms; the
    # card is busy 0-50 and 500-600 ms: idle 50-500 and 600-1000 ms
    # (850 ms); the spans cover 0-151, 200-351, 400-551 and 900-901 ms,
    # so 50-151, 200-351, 400-500 and 900-901 of the idle time (353 ms)
    prog = _program()
    sub = {"busy_ns": [(10**18, 10**18 + 50 * MS),
                       (10**18 + 500 * MS, 10**18 + 600 * MS)],
           "window_s": 1.0, "busy_s": 0.15}
    ctx = {"program": prog, "sub": sub, "sub_t0": 0.0, "sub_t1": 1.0}
    assert read("idle_unexplained_share", ctx) == pytest.approx(
        100 * (850 - 353) / 850)
    # no span at all: every idle ns is unexplained; no busy_ns: nothing
    empty = {"spans": [S("vtd.x", 1, -1, 5000 * MS, 5001 * MS, 0, 1)],
             "clock": prog["clock"]}
    assert read("idle_unexplained_share", dict(ctx, program=empty)) == 100.0
    assert read("idle_unexplained_share",
                dict(ctx, sub={"window_s": 1.0, "busy_s": 0.15})) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_the_programs_spans(name):
    for ctx in ({}, {"program": None}, {"program": {"spans": [], "clock": (0, 0)}}):
        ctx.update(sub=None, sub_t0=None, sub_t1=None)
        assert read(name, ctx) is None


def _old_context():
    cfg = json.load(open(os.path.join(REPO, "portbench", "configs",
                                      "dbnet_r50_trocr_base.json")))
    calls = {layer: [(1.0 + i, 1.2 + i, 16) for i in range(4)]
             for layer in ("decode", "dispatch", "dbnet", "postprocess",
                           "crnn", "trocr")}
    names = ("pb.dbnet", "pb.postprocess", "pb.crnn", "pb.trocr")
    return {
        "spans": {k: [0.2] * 4 for k in calls}, "calls": calls,
        "counts": {"valid_frames": 48}, "engine_batches": 4,
        "sub": {"window_s": 1.5, "busy_s": 0.4, "gaps": [],
                "device_s": {"void strip_kernel(int*)": 1e-3, "gemm": 0.2},
                "range_device_s": {n: 0.03 for n in names},
                "range_count": {n: 2 for n in names}},
        "sub_t0": 2.5, "sub_t1": 4.0,
        "sub_counters": {"segmented_cc_round.launches": 6}, "config": cfg,
    }


def test_the_existing_readers_ignore_the_new_keys():
    old = _old_context()
    new = dict(old, program=_program(),
               sub=dict(old["sub"], busy_ns=[(0, 10), (20, 30)]))
    got = {name: read(name, old) for name in OLD}
    assert all(v is not None for v in got.values()), got
    assert {name: read(name, new) for name in OLD} == got


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


def test_spans_run_records_a_tiny_cell_on_the_cpu(tiny):
    """``spans_run`` on a tiny CRNN cell: the run is correct, the host
    readers read the recorded spans (no sub-window on the CPU, so no
    idle share), and the window's own frames/s is reported."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import torch; torch.set_num_threads(2)\n"
        "from portbench import run, spans_run\n"
        "r = spans_run.run('tiny_crnn_c', 2**31 + 13, 3.0, True, True,"
        " root='.', device='cpu')\n"
        "run.emit(r)\n"
    )
    env = dict(os.environ, PYTHONPATH=tiny)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny, capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    for name in ("dispatch_cpu_ms", "postprocess_sync_ms", "dbnet_host_ms",
                 "collect_wait_ms", "decode_busy_ms"):
        assert res["metrics"][name]["value"] >= 0, name
    assert res["metrics"]["dbnet_host_ms"]["value"] > 0
    assert "idle_unexplained_share" not in res["metrics"]
    assert "dispatch_ms" in res["metrics"]  # the benchmark's own readers
    spans = res["spans"]
    assert spans["record"] is True and spans["window_frames_per_s"] > 0
    assert spans["by_name"]["vtd.dispatch"]["count"] > 0
