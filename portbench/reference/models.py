"""Plain forward passes of the benchmark's three models, in float32.

Written from the published descriptions and the weights' own layouts:

* DBNet (Liao et al., arXiv:1911.08947): ResNet-50 (3, 4, 6, 3
  bottlenecks, 7x7/2 stem, 3x3/2 max pool), an FPN of 256 laterals and
  four 64-wide 3x3 smooths upsampled to stride 4 and concatenated, and the
  probability branch: 3x3 conv, BatchNorm, ReLU, two learned 2x
  upsamplings (a 1x1 conv to 4C and depth-to-space), sigmoid. The weights
  are the flax tree of the checkpoint (HWIO kernels, ``scale``/``bias``
  and ``mean``/``var``); depth-to-space takes channel ``(a*2+b)*C + c``
  to the pixel ``(2i+a, 2j+b)``, as the checkpoint's model does.
* CRNN (Shi et al., arXiv:1507.05717): seven conv-BN-ReLU layers with
  2x2, 2x2, (2,1), (2,1) max pools, a 2-layer bidirectional LSTM of 256
  (gates i, f, g, o) and a linear classifier over 97 CTC classes.
* TrOCR (Li et al., arXiv:2109.10282; microsoft/trocr-base-printed): a
  pre-norm ViT encoder (16x16 patches, CLS token, learned positions, exact
  GELU) and a post-norm decoder (learned positions offset by 2, a
  LayerNorm on the embeddings, self-, cross-attention and MLP each
  followed by add and LayerNorm, an output head without bias). The
  weights come as a flat dict of tensors named as the benchmark makes
  them (``configs/dbnet_r50_trocr_base.json`` lists the names).

Every convolution and matrix product goes through ``q`` on both operands:
the identity for the reference, a rounding to a lower precision for the
control (``control.py``). No kernel, cache or batching trick: the decoder
recomputes the whole prefix (teacher forcing).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]
BN_EPS = 1e-5


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def to_device(tree, device) -> Dict:
    """A nested dict of numpy arrays -> the same of float32 tensors."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


def _conv(x, kernel, q: Q, stride=1, pad=0, bias=None):
    w = kernel.permute(3, 2, 0, 1)  # HWIO -> OIHW
    return F.conv2d(q(x), q(w), bias, stride, pad)


def _bn(x, p, s):
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(s["var"] + BN_EPS) * p["scale"]
    return (x - s["mean"].view(shape)) * inv.view(shape) + p["bias"].view(shape)


def _d2s(x: torch.Tensor) -> torch.Tensor:
    """[B, 4C, H, W] with channel (a*2+b)*C + c -> [B, C, 2H, 2W]."""
    b, c4, h, w = x.shape
    c = c4 // 4
    return (x.view(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
            .reshape(b, c, 2 * h, 2 * w))


def _up(x, f):
    return F.interpolate(x, scale_factor=f, mode="nearest")


def dbnet_probability(x: torch.Tensor, v: Dict, q: Q = identity) -> torch.Tensor:
    """Normalised NCHW float32 images -> probability maps [B, H, W]."""
    p, s = v["params"], v["batch_stats"]
    bp, bs = p["backbone"], s["backbone"]
    y = F.relu(_bn(_conv(x, bp["conv1"]["kernel"], q, 2, 3), bp["bn1"], bs["bn1"]))
    y = F.max_pool2d(y, 3, 2, 1)
    taps = []
    for stage, n_blocks in enumerate((3, 4, 6, 3), start=1):
        for blk in range(n_blocks):
            name = f"layer{stage}_{blk}"
            bpp, bss = bp[name], bs[name]
            stride = 2 if (stage > 1 and blk == 0) else 1
            z = F.relu(_bn(_conv(y, bpp["conv1"]["kernel"], q), bpp["bn1"], bss["bn1"]))
            z = F.relu(_bn(_conv(z, bpp["conv2"]["kernel"], q, stride, 1),
                           bpp["bn2"], bss["bn2"]))
            z = _bn(_conv(z, bpp["conv3"]["kernel"], q), bpp["bn3"], bss["bn3"])
            if "downsample_conv" in bpp:
                y = _bn(_conv(y, bpp["downsample_conv"]["kernel"], q, stride),
                        bpp["downsample_bn"], bss["downsample_bn"])
            y = F.relu(z + y)
        taps.append(y)
    fp = p["fpn"]
    c2, c3, c4, c5 = taps
    p5 = _conv(c5, fp["lateral5"]["kernel"], q)
    p4 = _conv(c4, fp["lateral4"]["kernel"], q) + _up(p5, 2)
    p3 = _conv(c3, fp["lateral3"]["kernel"], q) + _up(p4, 2)
    p2 = _conv(c2, fp["lateral2"]["kernel"], q) + _up(p3, 2)
    feats = torch.cat([
        _conv(p2, fp["smooth2"]["kernel"], q, 1, 1),
        _up(_conv(p3, fp["smooth3"]["kernel"], q, 1, 1), 2),
        _up(_conv(p4, fp["smooth4"]["kernel"], q, 1, 1), 4),
        _up(_conv(p5, fp["smooth5"]["kernel"], q, 1, 1), 8),
    ], 1)
    hp, hs = p["head"]["probability"], s["head"]["probability"]
    z = F.relu(_bn(_conv(feats, hp["conv"]["kernel"], q, 1, 1), hp["bn1"], hs["bn1"]))
    z = _d2s(_conv(z, hp["up1"]["conv"]["kernel"], q, bias=hp["up1"]["conv"]["bias"]))
    z = F.relu(_bn(z, hp["bn2"], hs["bn2"]))
    z = _d2s(_conv(z, hp["up2"]["conv"]["kernel"], q, bias=hp["up2"]["conv"]["bias"]))
    return torch.sigmoid(z)[:, 0]


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def detector_input(bgr_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 BGR [B, H, W, 3] -> normalised RGB NCHW [B, 3, size, size]:
    /255, antialiased bilinear resize with half-pixel centres, ImageNet
    mean and deviation."""
    x = bgr_u8.permute(0, 3, 1, 2).float().flip(1) / 255.0
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


# conv index, kernel size, padding, pool after it
_CRNN_LAYERS = ((0, 3, 1, (2, 2)), (1, 3, 1, (2, 2)), (2, 3, 1, None),
                (3, 3, 1, (2, 1)), (4, 3, 1, None), (5, 3, 1, (2, 1)),
                (6, 2, 0, None))


def _lstm_dir(x, p, sfx, q: Q):
    """One direction of one LSTM layer over [N, T, D] -> [N, T, H]."""
    w_ih, w_hh = p[f"weight_ih{sfx}"], p[f"weight_hh{sfx}"]
    bias = p[f"bias_ih{sfx}"] + p[f"bias_hh{sfx}"]
    n, t, _ = x.shape
    hid = w_hh.shape[1]
    h = x.new_zeros(n, hid)
    c = x.new_zeros(n, hid)
    xw = q(x) @ q(w_ih).T + bias
    out = []
    for step in range(t):
        g = xw[:, step] + q(h) @ q(w_hh).T
        i, f, gg, o = g.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, 1)


def crnn_logits(crops: torch.Tensor, v: Dict, q_conv: Q = identity,
                q_rnn: Q = identity) -> torch.Tensor:
    """[N, 32, 128, 3] crops in [0, 1] -> logits [N, 31, 97]."""
    p, s = v["params"], v["batch_stats"]
    x = crops.permute(0, 3, 1, 2).float()
    for k, ksize, pad, pool in _CRNN_LAYERS:
        x = _conv(x, p[f"conv{k}"]["kernel"], q_conv, 1, pad,
                  bias=p[f"conv{k}"]["bias"])
        x = F.relu(_bn(x, p[f"bn{k}"], s[f"bn{k}"]))
        if pool is not None:
            x = F.max_pool2d(x, pool, pool)
    n, c, h, w = x.shape
    seq = x.permute(0, 3, 1, 2).reshape(n, w, c * h)
    rnn = p["rnn"]
    for layer in range(2):
        fwd = _lstm_dir(seq, rnn, f"_l{layer}", q_rnn)
        bwd = _lstm_dir(seq.flip(1), rnn, f"_l{layer}_reverse", q_rnn).flip(1)
        seq = torch.cat([fwd, bwd], -1)
    cls = p["classifier"]
    return q_rnn(seq) @ q_rnn(cls["kernel"]) + cls["bias"]


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], w[prefix + ".weight"],
                        w[prefix + ".bias"], eps)


def _lin(x, w, prefix, q: Q):
    b = w.get(prefix + ".bias")
    y = q(x) @ q(w[prefix + ".weight"]).T
    return y if b is None else y + b


def _attn(xq, xkv, w, prefix, heads, q: Q, causal=False):
    b, tq, d = xq.shape
    tk = xkv.shape[1]
    hd = d // heads
    qh = _lin(xq, w, prefix + ".q", q).view(b, tq, heads, hd).transpose(1, 2)
    kh = _lin(xkv, w, prefix + ".k", q).view(b, tk, heads, hd).transpose(1, 2)
    vh = _lin(xkv, w, prefix + ".v", q).view(b, tk, heads, hd).transpose(1, 2)
    scores = (q(qh) @ q(kh).transpose(-1, -2)) * hd ** -0.5
    if causal:
        mask = torch.ones(tq, tk, dtype=torch.bool, device=xq.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    out = q(torch.softmax(scores, -1)) @ q(vh)
    return _lin(out.transpose(1, 2).reshape(b, tq, d), w, prefix + ".o", q)


def _mlp(x, w, prefix, q: Q):
    return _lin(F.gelu(_lin(x, w, prefix + ".fc1", q)), w, prefix + ".fc2", q)


def trocr_encode(images: torch.Tensor, w: Dict, cfg: Dict, q: Q = identity):
    """Normalised NHWC images [N, 384, 384, 3] -> encoder states [N, 577, 768]."""
    ps = cfg["patch_size"]
    x = F.conv2d(q(images.permute(0, 3, 1, 2).float()),
                 q(w["encoder.patch_embed.weight"]),
                 w["encoder.patch_embed.bias"], stride=ps)
    x = x.flatten(2).transpose(1, 2)
    cls = w["encoder.cls_token"].expand(x.shape[0], 1, x.shape[2])
    x = torch.cat([cls, x], 1) + w["encoder.pos_embed"]
    eps = cfg["enc_ln_eps"]
    for i in range(cfg["enc_layers"]):
        pre = f"encoder.block{i}"
        y = _ln(x, w, pre + ".ln1", eps)
        x = x + _attn(y, y, w, pre + ".attn", cfg["enc_heads"], q)
        x = x + _mlp(_ln(x, w, pre + ".ln2", eps), w, pre + ".mlp", q)
    return _ln(x, w, "encoder.ln_f", eps)


def trocr_decode(tokens: torch.Tensor, enc: torch.Tensor, w: Dict, cfg: Dict,
                 q: Q = identity) -> torch.Tensor:
    """Teacher-forced decoder: tokens [N, T] -> logits [N, T, V]."""
    t = tokens.shape[1]
    off = cfg["pos_offset"]
    eps = cfg["dec_ln_eps"]
    x = w["decoder.tok_embed.weight"][tokens.long()]
    x = x + w["decoder.pos_embed"][:, off:off + t]
    x = _ln(x, w, "decoder.ln_emb", eps)
    for i in range(cfg["dec_layers"]):
        pre = f"decoder.block{i}"
        x = _ln(x + _attn(x, x, w, pre + ".self_attn", cfg["dec_heads"], q,
                          causal=True), w, pre + ".ln1", eps)
        x = _ln(x + _attn(x, enc, w, pre + ".cross_attn", cfg["dec_heads"], q),
                w, pre + ".ln2", eps)
        x = _ln(x + _mlp(x, w, pre + ".mlp", q), w, pre + ".ln3", eps)
    return _lin(x, w, "decoder.lm_head", q)
