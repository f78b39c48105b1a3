"""Float32 error of the port's train-mode BatchNorm on the trained
detector's stem, against float64.

Feeds two synthetic 320x320 frames through ``models/text_detector``'s
stem convolution and normalises the result three ways, each in float32
and measured against the same computation in float64:

  * ``F.batch_norm`` in train mode (the one-card path of
    ``vtd_tpu_torch/models/resnet.py:BatchNorm2d``);
  * the unshifted fast variance ``E[x^2] - E[x]^2``;
  * ``BatchNorm2d._global_forward`` (the data-parallel path, sums shifted
    by the running mean), with the all-reduce of a one-rank group.

Run:  python tools/torch_bn_precision.py  (CPU by default; --device cuda)
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args()

    import vtd_tpu_torch.models.resnet as resnet
    from vtd_tpu_torch.convert import dbnet_from_jax
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.train.checkpoint import load_weights
    from vtd_tpu_torch.train.train_detector import synthesize_detection_data

    dev = torch.device(args.device)
    model = DBNet(dtype=torch.float32)
    model.load_state_dict(load_weights("models/text_detector", dbnet_from_jax))
    model.to(dev)
    images, _ = synthesize_detection_data(2, 320, seed=0)
    with torch.no_grad():
        h = model.backbone.conv1(
            torch.from_numpy(images).to(dev).permute(0, 3, 1, 2))
    bn = model.backbone.bn1
    resnet.all_reduce_sum = lambda t, group: t  # a one-rank group

    def plain(x):
        return F.batch_norm(x, None, None, bn.weight.to(x.dtype),
                            bn.bias.to(x.dtype), training=True,
                            momentum=0.0, eps=bn.eps)

    def unshifted(x):
        c, s = x.shape[1], (1, -1, 1, 1)
        mean = x.mean((0, 2, 3))
        var = (x.square().mean((0, 2, 3)) - mean.square()).clamp_min(0)
        return ((x - mean.view(s)) * torch.rsqrt(var.view(s) + bn.eps)
                * bn.weight.to(x.dtype).view(s) + bn.bias.to(x.dtype).view(s))

    def shifted(x):
        saved = [b.clone() for b in (bn.running_mean, bn.running_var,
                                     bn.num_batches_tracked)]
        try:
            with torch.no_grad():
                return bn._global_forward(x, group=None)
        finally:
            for b, v in zip((bn.running_mean, bn.running_var,
                             bn.num_batches_tracked), saved):
                b.copy_(v)

    x64 = h.double()
    spread = x64.var((0, 2, 3), unbiased=False)
    print(f"stem activations {tuple(h.shape)} on {dev}: channel means up to "
          f"{x64.mean((0, 2, 3)).abs().max().item():.4f}, variances down to "
          f"{spread.min().item():.6f}")
    for name, fn in (("F.batch_norm", plain), ("unshifted fast variance",
                                              unshifted),
                     ("_global_forward (shifted)", shifted)):
        with torch.no_grad():
            err = (fn(h).double() - fn(x64)).abs().max().item()
        print(f"{name}: float32 output off its float64 by {err:.3e}")


if __name__ == "__main__":
    main()
