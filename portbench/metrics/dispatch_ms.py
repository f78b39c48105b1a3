"""Runtime pipeline (``runtime/pipeline.py`` ``_dispatch_batch``): host ms
per batch to upload it and enqueue the device program; every eager
launch of the detection half, and the CRNN's, is paid here. Moves
``frames_per_s``."""
from ._common import host_ms

UNIT = "ms"


def read(ctx):
    return host_ms(ctx, "dispatch")
