"""Small helpers the readers share."""
from __future__ import annotations

from statistics import fmean


def host_ms(ctx, layer):
    """Mean host ms a call over the window, the calls that overlap the
    profiled sub-window left out (the profiler slows the host)."""
    t0, t1 = ctx.get("sub_t0"), ctx.get("sub_t1")
    xs = [e - s for s, e, _ in ctx["calls"].get(layer, [])
          if t0 is None or e < t0 or s > t1]
    return fmean(xs) * 1e3 if xs else None


def device_ms(ctx, layer):
    sub = ctx.get("sub")
    if not sub:
        return None
    n = sub["range_count"].get("pb." + layer, 0)
    if not n:
        return None
    return sub["range_device_s"]["pb." + layer] / n * 1e3


def items_in_sub(ctx, layer):
    """Items of the calls of ``layer`` that ran inside the sub-window."""
    t0, t1 = ctx.get("sub_t0"), ctx.get("sub_t1")
    if t0 is None:
        return 0
    return sum(n for s, e, n in ctx["calls"].get(layer, []) if s >= t0 and e <= t1)
