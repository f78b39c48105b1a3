"""DBNet (``TextDetector.probability``, span ``vtd.dbnet``): wall ms a
batch of the host side of DBNet's eager launches. Moves
``frames_per_s``."""
from ._spans import mean_ms

UNIT = "ms"


def read(ctx):
    return mean_ms(ctx, "vtd.dbnet")
