"""Video decode (``extract_frame_batches``' producer threads): wall ms of
their work (``vtd.decode_read``, the source frames' grabs and each
candidate's retrieve; ``vtd.decode_prep``, the keyframe gate, resize and
I420) per shipped batch (a ``vtd.decode`` span with frames). Moves
``frames_per_s``."""
from ._spans import outside_sub

UNIT = "ms"


def read(ctx):
    batches = sum(1 for _, s in outside_sub(ctx, "vtd.decode") if s.items > 0)
    if not batches:
        return None
    busy = sum(s.t1_ns - s.t0_ns for name in ("vtd.decode_read", "vtd.decode_prep")
               for _, s in outside_sub(ctx, name))
    return busy / batches * 1e-6
