"""DB postprocess (``ops/db_postprocess.py``): host ms per batch inside
the ``db_postprocess`` call, that is, its launch cost and its waits for
the labelling's convergence checks. Moves ``frames_per_s``."""
from ._common import host_ms

UNIT = "ms"


def read(ctx):
    return host_ms(ctx, "postprocess")
