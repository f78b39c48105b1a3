"""Model operations per unit of work, from the published shapes."""
from __future__ import annotations

from typing import Dict


def conv_flops(h_out: int, w_out: int, c_in: int, c_out: int, kh: int,
               kw: int) -> int:
    return 2 * h_out * w_out * c_out * c_in * kh * kw


def matmul_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def dbnet_flops_per_frame(size: int = 640, stage_sizes=(3, 4, 6, 3),
                          fpn: int = 256) -> int:
    """DBNet's inference path (ResNet-50, FPN, the probability branch) on
    one ``size`` x ``size`` frame."""
    r = size // 2
    total = conv_flops(r, r, 3, 64, 7, 7)  # stem, stride 2
    r //= 2  # max pool
    c_in = 64
    widths = (64, 128, 256, 512)
    level_ch = []
    for stage, (n, f) in enumerate(zip(stage_sizes, widths)):
        for blk in range(n):
            stride = 2 if (stage > 0 and blk == 0) else 1
            r_out = r // stride
            total += conv_flops(r, r, c_in, f, 1, 1)
            total += conv_flops(r_out, r_out, f, f, 3, 3)
            total += conv_flops(r_out, r_out, f, 4 * f, 1, 1)
            if c_in != 4 * f or stride != 1:
                total += conv_flops(r_out, r_out, c_in, 4 * f, 1, 1)
            c_in, r = 4 * f, r_out
        level_ch.append((r, c_in))
    for res, ch in level_ch:  # laterals and 3x3 smooths
        total += conv_flops(res, res, ch, fpn, 1, 1)
        total += conv_flops(res, res, fpn, fpn // 4, 3, 3)
    r4 = size // 4
    mid = fpn // 4
    total += conv_flops(r4, r4, fpn, mid, 3, 3)       # head conv
    total += conv_flops(r4, r4, mid, 4 * mid, 1, 1)   # up1
    total += conv_flops(2 * r4, 2 * r4, mid, 4, 1, 1)  # up2
    return total


def crnn_flops_per_slot(h: int = 32, w: int = 128, hidden: int = 256,
                        layers: int = 2, vocab: int = 97) -> int:
    """One 32x128 crop through the CRNN: the conv stack, the BiLSTM and
    the classifier."""
    plan = ((3, 64, 3, (2, 2)), (64, 128, 3, (2, 2)), (128, 256, 3, None),
            (256, 256, 3, (2, 1)), (256, 512, 3, None), (512, 512, 3, (2, 1)))
    total = 0
    for c_in, c_out, k, pool in plan:
        total += conv_flops(h, w, c_in, c_out, k, k)
        if pool:
            h, w = h // pool[0], w // pool[1]
    h, w = h - 1, w - 1  # the last 2x2 convolution without padding
    total += conv_flops(h, w, 512, 512, 2, 2)
    t = w
    d_in = 512 * h
    for _ in range(layers):
        total += 2 * t * (matmul_flops(1, d_in, 4 * hidden)
                          + matmul_flops(1, hidden, 4 * hidden))
        d_in = 2 * hidden
    return total + t * matmul_flops(1, 2 * hidden, vocab)


def trocr_encoder_flops_per_crop(c: Dict) -> int:
    """The ViT encoder on one crop, and the decoder's cross-attention keys
    and values projected from it once."""
    p = (c["image_size"] // c["patch_size"]) ** 2
    n = p + 1
    d = c["enc_dim"]
    total = matmul_flops(p, 3 * c["patch_size"] ** 2, d)
    per_layer = (4 * matmul_flops(n, d, d) + 2 * matmul_flops(n, d, n)
                 + 2 * matmul_flops(n, d, c["enc_mlp"]))
    total += c["enc_layers"] * per_layer
    total += c["dec_layers"] * 2 * matmul_flops(n, d, c["dec_dim"])
    return total


def trocr_decoder_flops_per_crop(c: Dict, steps: int = 0) -> int:
    """``steps`` (default ``max_len``) greedy decoder steps of one crop
    with a key/value cache: step ``t`` attends to ``t + 1`` positions of
    its own and to every encoder position."""
    steps = steps or c["max_len"]
    n = (c["image_size"] // c["patch_size"]) ** 2 + 1
    d = c["dec_dim"]
    total = 0
    for t in range(steps):
        layer = (4 * matmul_flops(1, d, d)            # self q, k, v, o
                 + 2 * matmul_flops(1, d, t + 1)       # self scores, mix
                 + 2 * matmul_flops(1, d, d)           # cross q, o
                 + 2 * matmul_flops(1, d, n)           # cross scores, mix
                 + 2 * matmul_flops(1, d, c["dec_mlp"]))
        total += c["dec_layers"] * layer + matmul_flops(1, d, c["vocab_size"])
    return total
