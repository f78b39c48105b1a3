"""CRNN recognizer: VGG-style conv stack -> 2-layer BiLSTM(256) -> linear
classifier over the CTC vocabulary (port of ``vtd_tpu/models/crnn.py``).

Module names follow the reference torch CRNN (``cnn.<index>``, ``rnn``,
``classifier``), the layout the reference's importer maps from, so such
state dicts load directly. The reference keeps torch's LSTM gate order
(i, f, g, o) and separate input/hidden biases, so ``nn.LSTM`` matches it.

Input NCHW [B, 3, 32, 128] in [0, 1]; output logits [B, T=31, V=97].
The conv stack computes in ``dtype`` (bf16 on the card, as the
reference; float32 for training, as the reference trains it) with
BatchNorm (flax's train-mode semantics, ``resnet.BatchNorm2d``), LSTM and
classifier in float32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .resnet import BatchNorm2d

VOCAB_CHARS = (
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~ "
)


def build_vocab() -> Dict[str, int]:
    """blank 0, the 95 printable characters at 1..95, <unk> 96."""
    vocab = {c: i + 1 for i, c in enumerate(VOCAB_CHARS)}
    vocab["<blank>"] = 0
    vocab["<unk>"] = len(vocab)
    return vocab


CRNN_VOCAB = build_vocab()
BLANK_ID = 0
UNK_ID = CRNN_VOCAB["<unk>"]
ID_TO_CHAR = {v: k for k, v in CRNN_VOCAB.items()}

BN_EPS = 1e-5


def _conv_bn_relu(cin, cout, k=3, pad=1):
    return [
        nn.Conv2d(cin, cout, k, padding=pad, bias=True),
        BatchNorm2d(cout, eps=BN_EPS),
        nn.ReLU(),
    ]


class CRNN(nn.Module):
    def __init__(
        self,
        vocab_size: int = len(CRNN_VOCAB),
        hidden_size: int = 256,
        num_layers: int = 2,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        # indices 0..24 as in the reference Sequential: conv at 0, 4, 8,
        # 11, 15, 18, 22 and BatchNorm right after each
        self.cnn = nn.Sequential(
            *_conv_bn_relu(3, 64), nn.MaxPool2d(2, 2),        # 16 x 64
            *_conv_bn_relu(64, 128), nn.MaxPool2d(2, 2),      # 8 x 32
            *_conv_bn_relu(128, 256),
            *_conv_bn_relu(256, 256), nn.MaxPool2d((2, 1), (2, 1)),  # 4 x 32
            *_conv_bn_relu(256, 512),
            *_conv_bn_relu(512, 512), nn.MaxPool2d((2, 1), (2, 1)),  # 2 x 32
            *_conv_bn_relu(512, 512, k=2, pad=0),             # 1 x 31
        )
        self.rnn = nn.LSTM(
            512, hidden_size, num_layers=num_layers, bidirectional=True,
            batch_first=True,
        )
        self.classifier = nn.Linear(2 * hidden_size, vocab_size)
        for m in self.cnn:
            if isinstance(m, nn.Conv2d):
                m.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # at least float32 after the convolutions (float64 stays float64)
        wide = torch.promote_types(
            next(self.classifier.parameters()).dtype, torch.float32)
        for m in self.cnn:
            if isinstance(m, nn.BatchNorm2d):
                x = m(x.to(wide))
            elif isinstance(m, (nn.ReLU, nn.MaxPool2d)):
                x = m(x)
            else:  # a convolution, whole or split over a mesh row
                x = m(x.to(next(m.parameters()).dtype))
        b, c, h, w = x.shape
        # [B, C, 1, T] -> [B, T, C*H] (H = 1)
        seq = x.permute(0, 3, 1, 2).reshape(b, w, c * h).to(wide)
        seq, _ = self.rnn(seq)
        return self.classifier(seq)
