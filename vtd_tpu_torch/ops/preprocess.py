"""Frame preprocessing on the device (port of ``vtd_tpu/ops/preprocess.py``).

uint8 frames in, normalised detector input out; I420 frames are turned
back into BGR first. Layouts follow the reference: NHWC at both ends.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# torchvision Normalize constants
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_INV_255 = float(torch.tensor(1 / 255, dtype=torch.float32))


def preprocess_frames(
    frames: torch.Tensor,
    out_size: int = 640,
    dtype: torch.dtype = torch.bfloat16,
    bgr_to_rgb: bool = True,
    antialias: bool = True,
) -> torch.Tensor:
    """uint8 [B, H, W, 3] BGR -> normalised RGB [B, S, S, 3] in ``dtype``
    (``bgr_to_rgb=False`` leaves the channel order as given).

    Bilinear resize with half-pixel centres, /255, ImageNet
    normalisation. With ``antialias`` a downscale widens the filter to
    the scale (what ``jax.image.resize(method="bilinear",
    antialias=True)`` computes); without it every output pixel is the
    plain 2-tap bilinear mix of its four nearest inputs, as
    ``antialias=False`` there. The result is an NHWC view of NCHW
    memory, so ``.permute(0, 3, 1, 2)`` hands the model a contiguous
    NCHW tensor without a copy.
    """
    x = frames.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    if bgr_to_rgb:
        x = x.flip(1)
    x = F.interpolate(
        x, size=(out_size, out_size), mode="bilinear",
        align_corners=False, antialias=antialias,
    )
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    x = (x - mean[:, None, None]) / std[:, None, None]
    return x.to(dtype).permute(0, 2, 3, 1)


def resize_with_padding(image: torch.Tensor, out_size: int = 640) -> torch.Tensor:
    """One image [H, W, 3] -> [out_size, out_size, 3] in its own dtype:
    aspect-preserving antialiased bilinear resize, centred on zeros
    (the reference's ``resize_with_padding``; a float result is cast
    back to an integer dtype by truncation, as ``astype`` does)."""
    h, w = image.shape[:2]
    scale = min(out_size / w, out_size / h)
    nw, nh = int(w * scale), int(h * scale)
    x = image.permute(2, 0, 1)[None].to(torch.float32)
    x = F.interpolate(
        x, size=(nh, nw), mode="bilinear", align_corners=False,
        antialias=True,
    )[0].permute(1, 2, 0)
    top = (out_size - nh) // 2
    left = (out_size - nw) // 2
    out = torch.zeros(
        (out_size, out_size, image.shape[2]), dtype=torch.float32,
        device=image.device,
    )
    out[top:top + nh, left:left + nw] = x
    return out.to(image.dtype)


def normalize_frame(frame: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1] (times the float32 reciprocal of 255,
    as the reference's compiled division is)."""
    return frame.to(torch.float32) * _INV_255


def denormalize_frame(frame: torch.Tensor) -> torch.Tensor:
    """float in [0, 1] -> uint8 (scaled, clipped, truncated)."""
    return torch.clamp(frame * 255.0, 0, 255).to(torch.uint8)


def yuv420_to_bgr(packed: torch.Tensor) -> torch.Tensor:
    """I420-packed [B, H*3/2, W] uint8 -> BGR [B, H, W, 3] uint8.

    Video-range BT.601, as cv2's COLOR_YUV2BGR_I420, with float32
    constants and round half to even. To give the reference's bytes
    exactly, the arithmetic rounds to float32 where the reference's
    compiled code does: it fuses each multiply-add into one FMA (one
    rounding), which float64 arithmetic followed by one rounding to
    float32 reproduces exactly at these magnitudes.
    """
    b, h15, w = packed.shape
    h = (h15 * 2) // 3
    f32, f64 = torch.float32, torch.float64

    def c(x):  # a float32 constant, held exactly in float64
        return float(torch.tensor(x, dtype=f32))

    def r32(x):
        return x.to(f32).to(f64)

    def up2(x):
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    y16 = packed[:, :h, :].to(f64) - 16.0
    u = up2(packed[:, h:h + h // 4, :].reshape(b, h // 2, w // 2)).to(f64)
    v = up2(packed[:, h + h // 4:, :].reshape(b, h // 2, w // 2)).to(f64)
    u, v = u - 128.0, v - 128.0
    yc = r32(c(1.164) * y16)
    r = r32(yc + c(1.596) * v)
    g = r32(r32(c(1.164) * y16 - r32(c(0.391) * u)) - c(0.813) * v)
    bl = r32(yc + c(2.018) * u)
    bgr = torch.stack([bl, g, r], dim=-1).to(f32)
    return torch.clamp(torch.round(bgr), 0, 255).to(torch.uint8)
