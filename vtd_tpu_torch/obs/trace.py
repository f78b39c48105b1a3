"""Spans of the port's host work: the one span recorder of the process.

``span(name, items=1)`` marks a stretch of host work at a layer boundary
(``vtd.dispatch``, ``vtd.dbnet``, ...); ``items`` is what the stretch
handled (frames, maps, crops) and may be set inside the block through the
object ``with`` binds. A span does something only while one of two things
runs:

* recording (``start()`` ... ``stop()``): each span that opens and closes
  in between is kept in memory as a :class:`Span`: its name, thread,
  enclosing span, ``time.perf_counter_ns()`` stamps, the thread's CPU time
  over it (``time.thread_time_ns()``) and its items. ``snapshot()`` hands
  them back with a clock pair that maps ``perf_counter_ns`` onto the
  Unix-epoch nanoseconds of ``torch.profiler``'s (kineto's) timeline;
* an operator's trace (``annotating()``, which the pipeline's
  ``profile_dir`` trace holds open): each span also opens a
  ``torch.profiler.record_function`` range of its name, so the trace shows
  the same names.

Otherwise ``span`` returns one shared null context: no clock read, no
allocation, no torch call.
"""
from __future__ import annotations

import contextlib
import itertools
import statistics
import threading
import time
from typing import Dict, List, NamedTuple, Tuple

_recording = False
_annotating = 0  # operator traces running
_active = False  # _recording or _annotating
_t_start = 0
_clock: Tuple[int, int] = (0, 0)
_records: List[tuple] = []
_ids = itertools.count()
_lock = threading.Lock()
_tls = threading.local()


class Span(NamedTuple):
    name: str
    thread: int  # threading.get_ident() of the thread that ran it
    parent: int  # index of the enclosing span in the snapshot, -1 for none
    t0_ns: int  # time.perf_counter_ns()
    t1_ns: int
    cpu_ns: int  # the thread's CPU time between t0 and t1
    items: int


class _Null:
    """What ``span`` returns when nothing runs: enters, exits and takes
    ``items`` without doing anything."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    items = property(lambda self: 0, lambda self, value: None)


_NULL = _Null()


class _Open:
    __slots__ = ("name", "items", "id", "parent", "t0", "c0", "range")

    def __init__(self, name: str, items: int):
        self.name = name
        self.items = items
        self.range = None

    def __enter__(self):
        if _annotating:
            import torch

            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent = stack[-1].id if stack else -1
        self.id = next(_ids)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()  # read inside the wall stamps
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        _tls.stack.pop()
        if _recording and self.t0 >= _t_start:
            _records.append((self.id, self.name, threading.get_ident(),
                             self.parent, self.t0, t1, c1 - self.c0,
                             int(self.items)))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, items: int = 1):
    """A context manager around host work of the layer ``name``."""
    if not _active:
        return _NULL
    return _Open(name, items)


def _epoch_offset_ns(reads: int = 5) -> int:
    """Unix-epoch ns minus ``perf_counter_ns``: the median over a few
    epoch reads, each between two monotonic reads."""
    out = []
    for _ in range(reads):
        a = time.perf_counter_ns()
        e = time.time_ns()
        b = time.perf_counter_ns()
        out.append(e - (a + b) // 2)
    return int(statistics.median(out))


def start() -> None:
    """Clear the kept spans and record from now on; a span already open
    is not kept."""
    global _recording, _active, _t_start, _clock
    with _lock:
        _records.clear()
        now = time.perf_counter_ns()
        _clock = (now, now + _epoch_offset_ns())
        _t_start = now
        _recording = _active = True


def stop() -> None:
    """Stop recording; the kept spans stay for ``snapshot``. A span still
    open is not kept."""
    global _recording, _active
    with _lock:
        _recording = False
        _active = bool(_annotating)


def snapshot() -> Dict:
    """``{"spans": [Span, ...] in order of their start, "clock":
    (perf_counter_ns, kineto's Unix-epoch ns at that moment)}``. A span
    whose enclosing span was not kept has ``parent`` -1."""
    recs = sorted(list(_records), key=lambda r: (r[4], r[0]))
    index = {r[0]: i for i, r in enumerate(recs)}
    spans = [Span(name, tid, index.get(parent, -1), t0, t1, cpu, items)
             for _, name, tid, parent, t0, t1, cpu, items in recs]
    return {"spans": spans, "clock": _clock}


@contextlib.contextmanager
def annotating():
    """While held, every span also opens a ``record_function`` range of
    its name (for an operator's ``torch.profiler`` trace)."""
    global _annotating, _active
    with _lock:
        _annotating += 1
        _active = True
    try:
        yield
    finally:
        with _lock:
            _annotating -= 1
            _active = _recording or bool(_annotating)

