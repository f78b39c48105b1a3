"""DB postprocess (``ops/db_postprocess.py``): device ms per batch of the
kernels launched inside ``db_postprocess``, over the profiled
sub-window. Moves ``frames_per_s``."""
from ._common import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "postprocess")
