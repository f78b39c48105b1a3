"""Model step (the whole per-batch program): model operations of the work
that ran inside the profiled sub-window (DBNet per frame, CRNN per
recognised slot, TrOCR encoder and 50 decoder steps per decoded crop;
``flops/``) over the sub-window's length times the H100's 989 TFLOP/s of
bf16. Moves ``frames_per_s``."""
from ..flops import (
    PEAK_BF16_FLOPS, crnn_flops_per_slot, dbnet_flops_per_frame,
    trocr_decoder_flops_per_crop, trocr_encoder_flops_per_crop,
)
from ._common import items_in_sub

UNIT = "%"


def read(ctx):
    sub = ctx.get("sub")
    if not sub or sub["window_s"] <= 0:
        return None
    cfg = ctx["config"]
    size = cfg["pipeline"].get("detector_input_size", 640)
    ops = items_in_sub(ctx, "dbnet") * dbnet_flops_per_frame(size)
    ops += items_in_sub(ctx, "crnn") * crnn_flops_per_slot()
    tc = cfg["recognizer"].get("trocr")
    if tc:
        crops = items_in_sub(ctx, "trocr")
        ops += crops * (trocr_encoder_flops_per_crop(tc)
                        + trocr_decoder_flops_per_crop(tc))
    if not ops:
        return None
    return 100.0 * ops / (sub["window_s"] * PEAK_BF16_FLOPS)
