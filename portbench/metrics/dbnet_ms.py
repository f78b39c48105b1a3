"""DBNet (``models/dbnet.py``, ``models/resnet.py``): device ms per batch
of the kernels launched inside ``TextDetector.probability`` (I420 input
is converted before it), over the profiled sub-window. Moves
``frames_per_s``."""
from ._common import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "dbnet")
