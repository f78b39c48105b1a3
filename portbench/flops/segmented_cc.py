"""Bytes of one call of the labelling kernel ``segmented_cc_round``.

A call reads a foreground map (one byte a cell) and a label map (int32)
and writes a label map (int32) of ``batch`` x ``h`` x ``w`` cells: each
byte counted once, whatever kernel of the call moves it and however often.
The postprocess labels at ``work_stride`` 2, so a 640 x 640 detector map
gives 320 x 320 cells.
"""


def segmented_cc_bytes_per_call(batch: int, h: int, w: int) -> int:
    return batch * h * w * (1 + 4 + 4)
