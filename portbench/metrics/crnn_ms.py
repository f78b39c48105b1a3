"""CRNN (``models/crnn.py``): device ms per batch inside
``TextRecognizer.logits`` over the profiled sub-window; the greedy CTC
after it (a few small kernels) is left out. Moves ``frames_per_s``."""
from ._common import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "crnn")
