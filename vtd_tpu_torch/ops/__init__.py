"""Device ops of the port, under the reference's 17 names
(``vtd_tpu/ops/__init__.py``). ``db_postprocess`` and the crops are
batched over frames; ``preprocess`` also holds ``resize_with_padding``,
``normalize_frame`` and ``denormalize_frame``."""
from .crop import (
    crop_and_resize_boxes,
    crop_and_resize_boxes_mm,
    rectify_polygons,
)
from .ctc import ctc_greedy_decode_arrays, decode_batch, ids_to_text
from .db_postprocess import (
    connected_components,
    db_postprocess,
    db_postprocess_batch,
    extract_detections,
)
from .nms import iou_matrix, nms, temporal_dedup
from .preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    preprocess_frames,
    yuv420_to_bgr,
)

__all__ = [
    "preprocess_frames",
    "yuv420_to_bgr",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "connected_components",
    "db_postprocess",
    "db_postprocess_batch",
    "extract_detections",
    "crop_and_resize_boxes",
    "crop_and_resize_boxes_mm",
    "rectify_polygons",
    "ctc_greedy_decode_arrays",
    "decode_batch",
    "ids_to_text",
    "iou_matrix",
    "nms",
    "temporal_dedup",
]
