"""Video layer (``video/processor.py``): host ms per batch spent in one
``next()`` of ``extract_frame_batches``, as the benchmark's span around
it reads it over the window. Moves ``frames_per_s``."""
from ._common import host_ms

UNIT = "ms"


def read(ctx):
    return host_ms(ctx, "decode")
