"""Per-layer metrics, one reader a file: ``<name>.py`` defines ``UNIT`` and
``read(ctx)``, which returns the metric's value or None where the run
gives it nothing to read (the harness then leaves the metric out).

``ctx`` holds what a traced run gathered (``harness.metric_context``):
``spans`` {layer: [host seconds a call]} over the window; ``calls``
{layer: [(start, end, items)]} on the host clock; ``counts`` (batches
and valid frames dispatched, TrOCR crops and chunks) over the window;
``sub`` the profiled sub-window's reduction (``profiling.reduce``) and
its host bounds ``sub_t0`` / ``sub_t1``; ``sub_counters`` the program's
counters' change over the sub-window; ``engine_batches``; ``config``.
"""
