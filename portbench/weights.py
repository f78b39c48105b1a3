"""The seeded TrOCR weights the benchmark makes and hands to both sides.

The repo holds no trained trocr-base, and the decode loop runs all its
steps whatever the weights say, so weights drawn from the seed do the
work trained ones would. They are drawn on the device with one
``torch.Generator`` in one call, in bfloat16 (the type they are served
in), and cut into tensors named as the port's TrOCR module names them:
projections and the patch embedding LeCun-normal with zero biases, token
embeddings normal(1/sqrt(width)), position embeddings normal(0.02), the
CLS token 0, LayerNorms at identity.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def trocr_shapes(c: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every tensor of the published graph."""
    e, d = c["enc_dim"], c["dec_dim"]
    ps = c["patch_size"]
    n = (c["image_size"] // ps) ** 2 + 1
    out = [("encoder.cls_token", (1, 1, e), "zero"),
           ("encoder.pos_embed", (1, n, e), "pos"),
           ("encoder.patch_embed.weight", (e, 3, ps, ps), "lecun"),
           ("encoder.patch_embed.bias", (e,), "zero")]

    def lin(name, n_out, n_in, bias=True):
        out.append((name + ".weight", (n_out, n_in), "lecun"))
        if bias:
            out.append((name + ".bias", (n_out,), "zero"))

    def ln(name, dim):
        out.append((name + ".weight", (dim,), "one"))
        out.append((name + ".bias", (dim,), "zero"))

    for i in range(c["enc_layers"]):
        p = f"encoder.block{i}"
        ln(p + ".ln1", e)
        for x in "qkvo":
            lin(f"{p}.attn.{x}", e, e)
        ln(p + ".ln2", e)
        lin(p + ".mlp.fc1", c["enc_mlp"], e)
        lin(p + ".mlp.fc2", e, c["enc_mlp"])
    ln("encoder.ln_f", e)
    out.append(("decoder.pos_embed", (1, c["max_len"] + c["pos_offset"], d), "pos"))
    out.append(("decoder.tok_embed.weight", (c["vocab_size"], d), "embed"))
    ln("decoder.ln_emb", d)
    for i in range(c["dec_layers"]):
        p = f"decoder.block{i}"
        ln(p + ".ln1", d)
        for x in "qkvo":
            lin(f"{p}.self_attn.{x}", d, d)
        ln(p + ".ln2", d)
        lin(f"{p}.cross_attn.q", d, d)
        lin(f"{p}.cross_attn.k", d, e)
        lin(f"{p}.cross_attn.v", d, e)
        lin(f"{p}.cross_attn.o", d, d)
        ln(p + ".ln3", d)
        lin(p + ".mlp.fc1", c["dec_mlp"], d)
        lin(p + ".mlp.fc2", d, c["dec_mlp"])
    lin("decoder.lm_head", c["vocab_size"], d, bias=c.get("head_bias", False))
    return out


def trocr_weights(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = trocr_shapes(c)
    total = sum(int(torch.Size(s).numel()) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.bfloat16)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, init in shapes:
        n = int(torch.Size(shape).numel())
        t = flat[at:at + n].view(shape)
        at += n
        if init == "zero":
            t.zero_()
        elif init == "one":
            t.fill_(1.0)
        elif init == "pos":
            t.mul_(0.02)
        elif init == "embed":
            t.mul_(shape[-1] ** -0.5)
        else:  # lecun: 1/sqrt(fan_in)
            t.mul_((n // shape[0]) ** -0.5)
        out[name] = t
    return out
