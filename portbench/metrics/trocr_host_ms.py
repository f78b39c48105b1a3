"""TrOCR (``models/trocr.py``, ``runtime/trocr_runtime.py``): host ms per
chunk inside ``TransformerRecognizer.generate`` (the encoder and 50 eager
decode steps are enqueued there). Moves ``frames_per_s``."""
from ._common import host_ms

UNIT = "ms"


def read(ctx):
    return host_ms(ctx, "trocr")
