"""One run of one cell with the program's span recorder on
(``vtd_tpu_torch/obs/trace.py``):

    python3 -m portbench.spans_run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--record <0|1>]

``harness.run`` as ``run.py`` calls it, with three things laid over it in
this process, which ``harness.py`` and ``profiling.py`` do not do:
``trace.start()`` just before the loop's window and ``trace.stop()``
after it (``--record 1``, the default); the recorder's snapshot in the
readers' context as ``ctx["program"]``; and the card's merged busy
intervals on kineto's clock as ``sub["busy_ns"]``. With ``--trace 1`` the
result's ``metrics`` also hold the span readers of ``SPAN_METRICS``, and
``spans`` the recorded spans outside the profiled sub-window by name
(count, mean wall, thread-CPU ms and items), the number of ``vtd.*``
ranges in the profiler's trace (0: no span reaches it as a range) and
the window's own frames/s. The last line of standard output is the
result, as with ``run.py``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench import run as _run  # noqa: E402  (its environment set-up)

faulthandler.enable()

SPAN_METRICS = ("dispatch_cpu_ms", "postprocess_sync_ms", "dbnet_host_ms",
                "collect_wait_ms", "decode_busy_ms", "trocr_step_host_ms",
                "idle_unexplained_share")


def _busy(sub):
    """(merged busy intervals of the card, ``vtd.*`` ranges) of the
    sub-window's trace, on kineto's clock."""
    from torch.autograd import DeviceType

    from .profiling import _union

    device, ranges = [], 0
    for ev in sub.prof.profiler.kineto_results.events():
        if ev.name().startswith("vtd."):
            ranges += 1
        elif ev.device_type() == DeviceType.CUDA and not ev.name().startswith("pb."):
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return _union(device)[1], ranges


def _by_name(ctx):
    from .metrics._spans import outside_sub

    out = {}
    for name in sorted({s.name for s in ctx["program"]["spans"]}):
        ss = [s for _, s in outside_sub(ctx, name)]
        if ss:
            out[name] = {
                "count": len(ss),
                "wall_ms": sum(s.t1_ns - s.t0_ns for s in ss) / len(ss) * 1e-6,
                "cpu_ms": sum(s.cpu_ns for s in ss) / len(ss) * 1e-6,
                "items": sum(s.items for s in ss) / len(ss)}
    return out


def run(workload, seed, seconds, trace_on, record, **kw):
    """``harness.run(workload, seed, seconds, trace_on, **kw)`` with the
    recorder on (``record``) and its readers -> the result dict."""
    from vtd_tpu_torch.obs import trace

    from . import harness, profiling

    seen = {}
    make_loop, metric_context, reduce = (
        harness.driver, harness.metric_context, profiling.reduce)

    def recording_loop(*a, **lkw):
        loop = make_loop(*a, **lkw)
        window = loop.window

        def recorded_window(*wa, **wkw):
            trace.start()
            try:
                return window(*wa, **wkw)
            finally:
                trace.stop()

        if record:
            loop.window = recorded_window
        return loop

    def reduce_with_busy(sub):
        red = reduce(sub)
        red["busy_ns"], seen["vtd_ranges"] = _busy(sub)
        return red

    def context(*a, **ckw):
        ctx = metric_context(*a, **ckw)
        ctx["program"] = trace.snapshot() if record else None
        seen["ctx"] = ctx
        return ctx

    harness.driver, harness.metric_context, profiling.reduce = (
        recording_loop, context, reduce_with_busy)
    try:
        result = harness.run(workload, seed, seconds, trace_on,
                             t_start=kw.pop("t_start", T_START), **kw)
    finally:
        harness.driver, harness.metric_context, profiling.reduce = (
            make_loop, metric_context, reduce)
    run_ = result["run"]
    extra = {"record": bool(record),
             "window_frames_per_s": run_["frames"] / run_["window_s"]}
    ctx = seen.get("ctx")
    if trace_on and record:
        for name in SPAN_METRICS:
            mod = harness.reader(name)
            value = mod.read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": float(value), "unit": mod.UNIT}
        extra["vtd_ranges_in_trace"] = seen.get("vtd_ranges")
        extra["by_name"] = _by_name(ctx)
    result["spans"] = extra
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell, spans recorded")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench.spans_run: no CUDA device", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 bool(args.record))
    _run.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
