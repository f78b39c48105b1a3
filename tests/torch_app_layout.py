"""A DBNet checkpoint in the original app's ``.pth`` layout, made from a
seed at full ResNet50 widths (``python tests/torch_app_layout.py OUT``
writes one).

The layout is the one ``vtd_tpu/models/import_torch.py:import_dbnet_pth``
reads: ``{"model_state_dict": sd}`` with torchvision's ResNet50 in an
``nn.Sequential`` under ``backbone.{0,1,4-7}`` (conv1, bn1, layer1-4)
and each head branch an ``nn.Sequential`` under
``head.{probability,threshold}_head`` (0 conv with bias, 1 bn, 3
ConvTranspose2d, 4 bn, 6 ConvTranspose2d). The app's FPN entries stand
in under ``fpn.*``, with a C5 lateral in every slot (its bug, SURVEY.md
§0); no importer reads them. Weights are LeCun-normal, BatchNorm
statistics away from identity. numpy and torch only: the card's machine
runs it too.
"""
import sys

import numpy as np

STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))  # width, blocks
HEAD_IN, HEAD_MID = 256, 64


def _conv(rng, out_ch, in_ch, k):
    w = rng.standard_normal((out_ch, in_ch, k, k)) / np.sqrt(in_ch * k * k)
    return w.astype(np.float32)


def _bn(rng, sd, prefix, n):
    sd[f"{prefix}.weight"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
    sd[f"{prefix}.bias"] = rng.normal(0.0, 0.05, n).astype(np.float32)
    sd[f"{prefix}.running_mean"] = rng.normal(0.0, 0.1, n).astype(np.float32)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(
        rng.integers(1, 10_000), np.int64)


def app_dbnet_state(seed: int = 0) -> dict:
    """{key: numpy array} of the app's DBNet."""
    rng = np.random.default_rng(seed)
    sd: dict = {"backbone.0.weight": _conv(rng, 64, 3, 7)}
    _bn(rng, sd, "backbone.1", 64)
    in_ch = 64
    for stage, (width, blocks) in enumerate(STAGES):
        for block in range(blocks):
            pre = f"backbone.{stage + 4}.{block}"
            sd[f"{pre}.conv1.weight"] = _conv(rng, width, in_ch, 1)
            _bn(rng, sd, f"{pre}.bn1", width)
            sd[f"{pre}.conv2.weight"] = _conv(rng, width, width, 3)
            _bn(rng, sd, f"{pre}.bn2", width)
            sd[f"{pre}.conv3.weight"] = _conv(rng, 4 * width, width, 1)
            _bn(rng, sd, f"{pre}.bn3", 4 * width)
            if block == 0:
                sd[f"{pre}.downsample.0.weight"] = _conv(
                    rng, 4 * width, in_ch, 1)
                _bn(rng, sd, f"{pre}.downsample.1", 4 * width)
            in_ch = 4 * width
    for i in range(4):
        sd[f"fpn.lateral_convs.{i}.weight"] = _conv(rng, 256, 2048, 1)
        sd[f"fpn.lateral_convs.{i}.bias"] = np.zeros(256, np.float32)
    for branch in ("probability_head", "threshold_head"):
        pre = f"head.{branch}"
        sd[f"{pre}.0.weight"] = _conv(rng, HEAD_MID, HEAD_IN, 3)
        sd[f"{pre}.0.bias"] = rng.normal(0.0, 0.05, HEAD_MID).astype(
            np.float32)
        _bn(rng, sd, f"{pre}.1", HEAD_MID)
        for idx, out_ch in ((3, HEAD_MID), (6, 1)):
            # ConvTranspose2d weight [in, out, 2, 2]
            w = rng.standard_normal((HEAD_MID, out_ch, 2, 2)) / np.sqrt(
                HEAD_MID)
            sd[f"{pre}.{idx}.weight"] = w.astype(np.float32)
            sd[f"{pre}.{idx}.bias"] = rng.normal(0.0, 0.05, out_ch).astype(
                np.float32)
        _bn(rng, sd, f"{pre}.4", HEAD_MID)
    return sd


def write_app_dbnet(path: str, seed: int = 0) -> dict:
    """Write ``{"model_state_dict": ...}`` with ``torch.save`` to
    ``path``; returns the numpy state dict."""
    import torch

    sd = app_dbnet_state(seed)
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in sd.items()}}, path)
    return sd


if __name__ == "__main__":
    write_app_dbnet(sys.argv[1])
