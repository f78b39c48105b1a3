"""Runtime pipeline (``_dispatch_batch``, span ``vtd.dispatch``): the
dispatcher thread's CPU ms a batch. ``dispatch_ms`` less this is its time
off the CPU: waits for the card, the GIL or the allocator. Moves
``frames_per_s``."""
from ._spans import mean_ms

UNIT = "ms"


def read(ctx):
    return mean_ms(ctx, "vtd.dispatch", "cpu")
