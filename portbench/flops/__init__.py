"""Operations and bytes of the benchmark's work, counted from shapes.

A multiply-add is two operations. Only convolutions and matrix products
count toward a model's operations (normalisation, activations and
pooling are left out); they are the same whatever implements them.
Peaks are NVIDIA's published dense rates of one H100 SXM at its full
700 W limit.
"""
from .models import (  # noqa: F401
    crnn_flops_per_slot, dbnet_flops_per_frame, trocr_decoder_flops_per_crop,
    trocr_encoder_flops_per_crop,
)
from .segmented_cc import segmented_cc_bytes_per_call  # noqa: F401

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
