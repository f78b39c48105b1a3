"""The traced run's profiled sub-window and what is read from it.

``torch.profiler`` records every thread's CPU ops (the dispatcher thread
launches the kernels, hence ``profile_all_threads``) and the card's
activity over a few steady batches inside the window. ``reduce`` turns
the trace into plain numbers:

  window_s      host seconds between the profiler's start and stop
  busy_s        the union of the card's activity intervals (kernels,
                copies, sets; not the ranges' mirrors) in seconds
  device_s      {kernel name: seconds}, summed
  range_device_s {pb.<layer>: seconds of the card's work launched inside
                that range}, and range_count {pb.<layer>: ranges}
  gaps          the card's idle gaps, longest first, each named by the
                ``pb.*`` ranges that were open on the host at its middle
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple


class SubWindow:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0

    @staticmethod
    def warm() -> None:
        """One empty trace in set-up: the profiler's first start in a
        process (CUPTI's) takes seconds, which must not fall in the window."""
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, the merged intervals in order)."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def reduce(sub: SubWindow) -> Dict:
    from torch.autograd import DeviceType

    prof = sub.prof
    device: List[Tuple[int, int, str]] = []
    ranges: List[Tuple[int, int, str]] = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            if ev.name().startswith("pb."):  # a range's mirror on the card's timeline
                continue
            s = ev.start_ns()
            device.append((s, s + ev.duration_ns(), ev.name()))
        elif ev.name().startswith("pb."):
            s = ev.start_ns()
            ranges.append((s, s + ev.duration_ns(), ev.name()))
    busy_ns, merged = _union([(s, e) for s, e, _ in device])
    device_s: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        device_s[name] += (e - s) * 1e-9

    range_device_s: Dict[str, float] = defaultdict(float)
    range_count: Dict[str, int] = defaultdict(int)
    for ev in prof.events():
        if ev.name.startswith("pb.") and ev.device_type == DeviceType.CPU:
            range_device_s[ev.name] += ev.device_time_total * 1e-6
            range_count[ev.name] += 1

    gaps = []
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) // 2
        open_ = sorted({n for s, e, n in ranges if s <= mid <= e})
        gaps.append(((s1 - e0) * 1e-9, "+".join(open_) or "no pb range"))
    gaps.sort(key=lambda g: -g[0])
    return {
        "window_s": sub.t1 - sub.t0,
        "busy_s": busy_ns * 1e-9,
        "device_s": dict(device_s),
        "range_device_s": dict(range_device_s),
        "range_count": dict(range_count),
        "gaps": gaps,
    }


def short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def breakdown(red: Dict) -> Dict:
    ops = sorted(red["device_s"].items(), key=lambda kv: -kv[1])[:10]
    ops = [(short(n), s) for n, s in ops]
    return {
        "device_ops": [[n, s] for n, s in ops],
        "idle_gaps": [[n, s] for s, n in red["gaps"][:10]],
    }
