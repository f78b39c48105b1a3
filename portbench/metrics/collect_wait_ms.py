"""Runtime pipeline (``_process_batch``, span ``vtd.collect``): wall ms a
batch in which the collecting host waits for the card's pack
(``vtd.collect_wait``). Moves ``frames_per_s``."""
from ._spans import children_ms_per

UNIT = "ms"


def read(ctx):
    return children_ms_per(ctx, "vtd.collect_wait", "vtd.collect")
