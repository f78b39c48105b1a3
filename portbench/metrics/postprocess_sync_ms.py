"""DB postprocess (``db_postprocess``, span ``vtd.postprocess``): wall ms
a batch in which the host waits for the card at the labelling's
stability checks (``vtd.cc_sync``, ``connected_components_scan``).
Moves ``frames_per_s``."""
from ._spans import children_ms_per

UNIT = "ms"


def read(ctx):
    return children_ms_per(ctx, "vtd.cc_sync", "vtd.postprocess")
