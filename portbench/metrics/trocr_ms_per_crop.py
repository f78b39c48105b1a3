"""TrOCR: device ms inside ``TransformerRecognizer.generate`` over the
profiled sub-window, divided by the crops those calls decoded. Moves
``frames_per_s``."""
from ._common import items_in_sub

UNIT = "ms"


def read(ctx):
    sub = ctx.get("sub")
    crops = items_in_sub(ctx, "trocr")
    if not sub or not crops or "pb.trocr" not in sub["range_device_s"]:
        return None
    return sub["range_device_s"]["pb.trocr"] / crops * 1e3
