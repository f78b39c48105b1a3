"""Device: the share of the profiled sub-window in which the card ran
nothing, 1 - (union of its activity intervals / the sub-window's host
length), in %. Moves ``frames_per_s``."""

UNIT = "%"


def read(ctx):
    sub = ctx.get("sub")
    if not sub or sub["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sub["busy_s"] / sub["window_s"])
