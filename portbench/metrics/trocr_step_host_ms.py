"""TrOCR (``greedy_decode``, span ``vtd.trocr_step``): wall ms of one of
the 50 decoder steps of a chunk, host side (the loop never waits for the
card). Moves ``frames_per_s``."""
from ._spans import mean_ms

UNIT = "ms"


def read(ctx):
    return mean_ms(ctx, "vtd.trocr_step")
