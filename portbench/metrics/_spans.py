"""What the span readers share: the program's own spans
(``vtd_tpu_torch/obs/trace.py``), read from ``ctx["program"]``, the
recorder's snapshot ``{"spans": [...], "clock": (perf_counter_ns,
kineto ns)}``. Each span has ``name``, ``thread``, ``parent`` (an index
into the list, -1 for none), ``t0_ns`` / ``t1_ns`` on ``perf_counter_ns``,
``cpu_ns`` and ``items``. A run without it (an untraced run, or a program
that records no span) gives None, which leaves the metric out."""
from __future__ import annotations

from statistics import fmean


def spans(ctx):
    snap = ctx.get("program")
    return snap["spans"] if snap and snap.get("spans") else None


def outside_sub(ctx, name):
    """(index, span) of the spans ``name`` that do not overlap the
    profiled sub-window (the profiler slows the host), as
    ``_common.host_ms`` keeps the calls."""
    ss = spans(ctx)
    if ss is None:
        return []
    t0, t1 = ctx.get("sub_t0"), ctx.get("sub_t1")
    lo = None if t0 is None else t0 * 1e9
    hi = None if t1 is None else t1 * 1e9
    return [(i, s) for i, s in enumerate(ss) if s.name == name
            and (lo is None or s.t1_ns < lo or s.t0_ns > hi)]


def mean_ms(ctx, name, field="wall"):
    """Mean wall (or thread-CPU, ``field="cpu"``) ms of a span ``name``."""
    xs = [(s.cpu_ns if field == "cpu" else s.t1_ns - s.t0_ns)
          for _, s in outside_sub(ctx, name)]
    return fmean(xs) * 1e-6 if xs else None


def children_ms_per(ctx, child, parent):
    """Wall ms of the spans ``child`` summed within each span ``parent``,
    the mean over the parents."""
    parents = outside_sub(ctx, parent)
    if not parents:
        return None
    ss = spans(ctx)
    keep = {i for i, _ in parents}
    total = sum(s.t1_ns - s.t0_ns for s in ss
                if s.name == child and s.parent in keep)
    return total / len(parents) * 1e-6
