"""Labelling kernel (``ops/cc_kernels.py``, ``csrc/segmented_cc.cu``):
the least time the wrapper calls of the profiled sub-window could take at
the card's 3.35 TB/s (calls counted by ``segmented_cc_round.launches``,
bytes per call from the labelling map's shape, ``flops/segmented_cc.py``)
over the device time of the kernels of ``segmented_cc.cu`` there, in %.
Moves ``frames_per_s``."""
import re

from ..flops import PEAK_HBM_BYTES, segmented_cc_bytes_per_call

UNIT = "%"
KERNELS = ("strip_kernel", "diag_kernel")  # the __global__s of segmented_cc.cu
# a demangled name, in a namespace or not, with its parameter list
_OURS = re.compile(r"(?:^|[\s:])(?:%s)\s*[(<]" % "|".join(KERNELS))


def read(ctx):
    sub = ctx.get("sub")
    calls = (ctx.get("sub_counters") or {}).get("segmented_cc_round.launches", 0)
    if not sub or not calls:
        return None
    secs = sum(s for name, s in sub["device_s"].items() if _OURS.search(name))
    if secs <= 0:
        return None
    p = ctx["config"]["pipeline"]
    cells = p.get("detector_input_size", 640) // 2
    need = calls * segmented_cc_bytes_per_call(p["batch_size"], cells, cells)
    return 100.0 * (need / PEAK_HBM_BYTES) / secs
