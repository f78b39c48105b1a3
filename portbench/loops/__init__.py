"""The loops that drive the port's entry, one file each.

A traffic mix's data file names its loop (``"loop": "closed"``); the
harness imports ``portbench.loops.<loop>`` and builds its ``Driver(traffic,
pipe, inputs, seed, log)``, which offers ``warm()``, ``window(seconds,
taps, on_sub, prof_start, prof_seconds)`` and ``close()``. A new kind of
loop is a new file here; a new mix of a kind that exists is a data file.
"""
