"""What the loops share."""
from __future__ import annotations

import time


def profile_sub_window(on_sub, t0: float, start_s: float, seconds: float, busy) -> None:
    """In the calling (main) thread: start the traced run's sub-window
    ``start_s`` into the window and stop it ``seconds`` later, or as soon
    as ``busy`` (the load's thread) ends."""
    if on_sub is None:
        return
    busy.join(timeout=max(0.0, t0 + start_s - time.perf_counter()))
    if not busy.is_alive():
        return
    on_sub(True)
    busy.join(timeout=seconds)
    on_sub(False)
