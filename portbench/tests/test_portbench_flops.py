"""The operation and byte counts against hand counts at small shapes."""
from __future__ import annotations

from portbench.flops import (
    crnn_flops_per_slot, dbnet_flops_per_frame, segmented_cc_bytes_per_call,
    trocr_decoder_flops_per_crop, trocr_encoder_flops_per_crop,
)
from portbench.flops.models import conv_flops


def test_conv_and_bytes_by_hand():
    # a 3x3 convolution 2 -> 4 channels on a 5x6 output: 5*6*4*2*9 MACs
    assert conv_flops(5, 6, 2, 4, 3, 3) == 2 * 5 * 6 * 4 * 2 * 9
    # 2 maps of 3x4 cells: a byte of foreground, 4 in, 4 out a cell
    assert segmented_cc_bytes_per_call(2, 3, 4) == 2 * 12 * 9


def test_dbnet_at_64_by_hand():
    s = 64
    stem = 2 * 32 * 32 * 64 * 3 * 49
    # ResNet-50 bottlenecks at 16, 8, 4, 2 pixels a side
    blocks = 0
    c_in, r = 64, 16
    for stage, (n, f) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(n):
            st = 2 if stage and b == 0 else 1
            ro = r // st
            blocks += 2 * (r * r * c_in * f + ro * ro * f * f * 9 + ro * ro * f * 4 * f)
            if b == 0:
                blocks += 2 * ro * ro * c_in * 4 * f
            c_in, r = 4 * f, ro
    fpn = sum(2 * (q * q * ch * 256 + q * q * 256 * 64 * 9)
              for q, ch in ((16, 256), (8, 512), (4, 1024), (2, 2048)))
    head = 2 * (16 * 16 * 256 * 64 * 9 + 16 * 16 * 64 * 256 + 32 * 32 * 64 * 4)
    assert dbnet_flops_per_frame(s) == stem + blocks + fpn + head


def test_crnn_by_hand():
    conv = 2 * (32 * 128 * 3 * 64 * 9 + 16 * 64 * 64 * 128 * 9 + 8 * 32 * 128 * 256 * 9
                + 8 * 32 * 256 * 256 * 9 + 4 * 32 * 256 * 512 * 9
                + 4 * 32 * 512 * 512 * 9 + 1 * 31 * 512 * 512 * 4)
    lstm = 2 * 31 * 2 * ((512 * 1024 + 256 * 1024) + (512 * 1024 + 256 * 1024))
    head = 2 * 31 * 512 * 97
    assert crnn_flops_per_slot() == conv + lstm + head


def test_trocr_by_hand():
    c = dict(image_size=32, patch_size=16, enc_dim=8, enc_layers=1, enc_mlp=16,
             dec_dim=4, dec_layers=1, dec_mlp=8, vocab_size=10, max_len=2)
    n = 5  # 4 patches and the CLS token
    enc = (2 * 4 * 768 * 8 + 4 * 2 * n * 8 * 8 + 2 * 2 * n * 8 * n
           + 2 * 2 * n * 8 * 16 + 2 * 2 * n * 8 * 4)
    assert trocr_encoder_flops_per_crop(c) == enc
    step = lambda t: (4 * 2 * 4 * 4 + 2 * 2 * 4 * (t + 1) + 2 * 2 * 4 * 4  # noqa: E731
                      + 2 * 2 * 4 * n + 2 * 2 * 4 * 8 + 2 * 4 * 10)
    assert trocr_decoder_flops_per_crop(c) == step(0) + step(1)
