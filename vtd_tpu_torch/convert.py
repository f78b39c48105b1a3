"""Carry weights from the JAX package's layout to the port's.

``dbnet_from_jax`` and ``crnn_from_jax`` take the ``{"params",
"batch_stats"}`` tree of ``vtd_tpu``'s flax models, as numpy arrays (of
any float dtype), and return the port's ``state_dict`` (float32 tensors):

  * convolution kernels HWIO -> OIHW;
  * Dense [in, out] -> Linear [out, in];
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
    (eps 1e-5 on both sides);
  * ``_Upsample2x``: output channels (a*2+b)*C + c -> c*4 + (a*2+b), the
    order ``F.pixel_shuffle`` reads;
  * the CRNN LSTM, already in torch layout and gate order, copies through.

``upsample_from_conv_transpose`` maps a reference torch
``ConvTranspose2d(k=2, s=2)`` onto ``_Upsample2x``.

``trocr_from_jax`` takes the ``{"params"}`` tree of ``vtd_tpu``'s TrOCR
(same submodule names as the port's: a rename, Dense transposes, the
patch-embedding kernel HWIO -> OIHW, LayerNorm ``scale`` -> ``weight``);
``trocr_from_hf_state`` takes an HF VisionEncoderDecoder TrOCR state dict
(already in torch layout: a rename only).

Plain numpy and torch: reading a JAX checkpoint is the caller's business.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_CRNN_CONV_INDEX = (0, 4, 8, 11, 15, 18, 22)  # cnn.<i> of conv0..conv6


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _conv(kernel) -> torch.Tensor:
    return _f32(np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1)))


def _bn(params, stats, prefix: str) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": _f32(params["scale"]),
        f"{prefix}.bias": _f32(params["bias"]),
        f"{prefix}.running_mean": _f32(stats["mean"]),
        f"{prefix}.running_var": _f32(stats["var"]),
        f"{prefix}.num_batches_tracked": torch.tensor(0, dtype=torch.int64),
    }


def _d2s_to_pixel_shuffle(x: np.ndarray) -> np.ndarray:
    """Leading axis (a*2+b)*C + c -> c*4 + (a*2+b)."""
    c4 = x.shape[0]
    return (
        x.reshape((4, c4 // 4) + x.shape[1:])
        .swapaxes(0, 1)
        .reshape(x.shape)
    )


def _upsample(params, prefix: str) -> Dict[str, torch.Tensor]:
    w = np.transpose(np.asarray(params["kernel"], np.float32), (3, 2, 0, 1))
    return {
        f"{prefix}.conv.weight": _f32(_d2s_to_pixel_shuffle(w)),
        f"{prefix}.conv.bias": _f32(
            _d2s_to_pixel_shuffle(np.asarray(params["bias"], np.float32))
        ),
    }


def upsample_from_conv_transpose(
    weight: np.ndarray, bias: np.ndarray, prefix: str
) -> Dict[str, torch.Tensor]:
    """torch ConvTranspose2d(k=2, s=2) weight [I, O, 2, 2] and bias [O] ->
    the ``_Upsample2x`` entries at ``prefix`` (out[2i+a, 2j+b, o] =
    sum_i x[i] W[i, o, a, b] + bias[o])."""
    w = np.asarray(weight, np.float32)
    i, o = w.shape[:2]
    conv_w = np.transpose(w, (1, 2, 3, 0)).reshape(4 * o, i, 1, 1)
    conv_b = np.repeat(np.asarray(bias, np.float32), 4)
    return {
        f"{prefix}.conv.weight": _f32(conv_w),
        f"{prefix}.conv.bias": _f32(conv_b),
    }


def dbnet_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``vtd_tpu.models.dbnet.DBNet`` variables -> ``DBNet`` state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    bp, bs = p["backbone"], s["backbone"]
    sd["backbone.conv1.weight"] = _conv(bp["conv1"]["kernel"])
    sd.update(_bn(bp["bn1"], bs["bn1"], "backbone.bn1"))
    for name in bp:
        if not name.startswith("layer"):
            continue
        stage, block = name[len("layer"):].split("_")
        pre = f"backbone.layer{stage}.{block}"
        blk, blk_s = bp[name], bs[name]
        for i in (1, 2, 3):
            sd[f"{pre}.conv{i}.weight"] = _conv(blk[f"conv{i}"]["kernel"])
            sd.update(_bn(blk[f"bn{i}"], blk_s[f"bn{i}"], f"{pre}.bn{i}"))
        if "downsample_conv" in blk:
            sd[f"{pre}.downsample.0.weight"] = _conv(
                blk["downsample_conv"]["kernel"]
            )
            sd.update(
                _bn(blk["downsample_bn"], blk_s["downsample_bn"],
                    f"{pre}.downsample.1")
            )
    for name, conv in p["fpn"].items():
        sd[f"fpn.{name}.weight"] = _conv(conv["kernel"])
    for branch in ("probability", "threshold"):
        hp, hs = p["head"][branch], s["head"][branch]
        pre = f"head.{branch}"
        sd[f"{pre}.conv.weight"] = _conv(hp["conv"]["kernel"])
        sd.update(_bn(hp["bn1"], hs["bn1"], f"{pre}.bn1"))
        sd.update(_upsample(hp["up1"]["conv"], f"{pre}.up1"))
        sd.update(_bn(hp["bn2"], hs["bn2"], f"{pre}.bn2"))
        sd.update(_upsample(hp["up2"]["conv"], f"{pre}.up2"))
    return sd


def crnn_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``vtd_tpu.models.crnn.CRNN`` variables -> ``CRNN`` state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for k, i in enumerate(_CRNN_CONV_INDEX):
        sd[f"cnn.{i}.weight"] = _conv(p[f"conv{k}"]["kernel"])
        sd[f"cnn.{i}.bias"] = _f32(p[f"conv{k}"]["bias"])
        sd.update(_bn(p[f"bn{k}"], s[f"bn{k}"], f"cnn.{i + 1}"))
    for name, value in p["rnn"].items():
        sd[f"rnn.{name}"] = _f32(value)
    sd["classifier.weight"] = _f32(np.transpose(p["classifier"]["kernel"]))
    sd["classifier.bias"] = _f32(p["classifier"]["bias"])
    return sd


def _dense(p, prefix: str) -> Dict[str, torch.Tensor]:
    out = {f"{prefix}.weight": _f32(np.transpose(np.asarray(p["kernel"])))}
    if "bias" in p:
        out[f"{prefix}.bias"] = _f32(p["bias"])
    return out


def _ln(p, prefix: str) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": _f32(p["scale"]),
        f"{prefix}.bias": _f32(p["bias"]),
    }


def _attention(p, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name in ("q", "k", "v", "o"):
        sd.update(_dense(p[name], f"{prefix}.{name}"))
    return sd


def _mlp(p, prefix: str) -> Dict[str, torch.Tensor]:
    return {**_dense(p["fc1"], f"{prefix}.fc1"),
            **_dense(p["fc2"], f"{prefix}.fc2")}


def trocr_from_jax(variables: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """``vtd_tpu.models.trocr.TrOCR`` variables -> ``TrOCR`` state_dict
    (float32; loading casts to the model's dtype). ``cfg`` is the port's
    ``TrOCRConfig`` of the same architecture. A tree of a post-norm
    decoder has no ``ln_f``, and neither has the port's module."""
    p = variables["params"]
    e, d = p["encoder"], p["decoder"]
    sd: Dict[str, torch.Tensor] = {
        "encoder.cls_token": _f32(e["cls_token"]),
        "encoder.pos_embed": _f32(e["pos_embed"]),
        "encoder.patch_embed.weight": _conv(e["patch_embed"]["kernel"]),
        "encoder.patch_embed.bias": _f32(e["patch_embed"]["bias"]),
    }
    sd.update(_ln(e["ln_f"], "encoder.ln_f"))
    for i in range(cfg.enc_layers):
        blk, pre = e[f"block{i}"], f"encoder.block{i}"
        sd.update(_ln(blk["ln1"], f"{pre}.ln1"))
        sd.update(_attention(blk["attn"], f"{pre}.attn"))
        sd.update(_ln(blk["ln2"], f"{pre}.ln2"))
        sd.update(_mlp(blk["mlp"], f"{pre}.mlp"))
    sd["decoder.tok_embed.weight"] = _f32(d["tok_embed"]["embedding"])
    sd["decoder.pos_embed"] = _f32(d["pos_embed"])
    if cfg.layernorm_embedding:
        sd.update(_ln(d["ln_emb"], "decoder.ln_emb"))
    for i in range(cfg.dec_layers):
        blk, pre = d[f"block{i}"], f"decoder.block{i}"
        sd.update(_ln(blk["ln1"], f"{pre}.ln1"))
        sd.update(_attention(blk["self_attn"], f"{pre}.self_attn"))
        sd.update(_ln(blk["ln2"], f"{pre}.ln2"))
        sd.update(_attention(blk["cross_attn"], f"{pre}.cross_attn"))
        sd.update(_ln(blk["ln3"], f"{pre}.ln3"))
        sd.update(_mlp(blk["mlp"], f"{pre}.mlp"))
    if not cfg.post_norm_decoder:
        sd.update(_ln(d["ln_f"], "decoder.ln_f"))
    sd.update(_dense(d["lm_head"], "decoder.lm_head"))
    return sd


_HF_ENC_LAYER = {
    "ln1": "layernorm_before", "attn.q": "attention.attention.query",
    "attn.k": "attention.attention.key", "attn.v": "attention.attention.value",
    "attn.o": "attention.output.dense", "ln2": "layernorm_after",
    "mlp.fc1": "intermediate.dense", "mlp.fc2": "output.dense",
}
_HF_DEC_LAYER = {
    "ln1": "self_attn_layer_norm", "ln2": "encoder_attn_layer_norm",
    "ln3": "final_layer_norm", "mlp.fc1": "fc1", "mlp.fc2": "fc2",
    **{f"{ours}.{n}": f"{theirs}.{hf}_proj"
       for ours, theirs in (("self_attn", "self_attn"),
                            ("cross_attn", "encoder_attn"))
       for n, hf in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))},
}


def trocr_from_hf_state(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF VisionEncoderDecoder (TrOCR) state dict (numpy arrays or
    tensors) -> ``TrOCR`` state_dict for a model built with
    ``hf_config(...)``: ViT encoder under ``encoder.*``, TrOCRForCausalLM
    under ``decoder.model.decoder.*`` + ``decoder.output_projection``
    (absent = tied to the token embedding). The ViT pooler is unused."""
    if not (cfg.post_norm_decoder and cfg.pos_offset == 2):
        raise ValueError(
            "trocr_from_hf_state needs a TrOCRConfig built by hf_config()"
        )
    emb = "encoder.embeddings"
    out: Dict[str, torch.Tensor] = {
        "encoder.cls_token": _f32(sd[f"{emb}.cls_token"]),
        "encoder.pos_embed": _f32(sd[f"{emb}.position_embeddings"]),
        "encoder.patch_embed.weight": _f32(
            sd[f"{emb}.patch_embeddings.projection.weight"]),
        "encoder.patch_embed.bias": _f32(
            sd[f"{emb}.patch_embeddings.projection.bias"]),
        "encoder.ln_f.weight": _f32(sd["encoder.layernorm.weight"]),
        "encoder.ln_f.bias": _f32(sd["encoder.layernorm.bias"]),
    }
    pre = "decoder.model.decoder"
    for n_layers, ours_fmt, theirs_fmt, names in (
        (cfg.enc_layers, "encoder.block{}", "encoder.encoder.layer.{}",
         _HF_ENC_LAYER),
        (cfg.dec_layers, "decoder.block{}", pre + ".layers.{}",
         _HF_DEC_LAYER),
    ):
        for i in range(n_layers):
            for ours, theirs in names.items():
                for leaf in ("weight", "bias"):
                    out[f"{ours_fmt.format(i)}.{ours}.{leaf}"] = _f32(
                        sd[f"{theirs_fmt.format(i)}.{theirs}.{leaf}"]
                    )
    n_pos = cfg.max_len + cfg.pos_offset
    tok = sd[f"{pre}.embed_tokens.weight"]
    out["decoder.tok_embed.weight"] = _f32(tok)
    out["decoder.pos_embed"] = _f32(
        np.asarray(sd[f"{pre}.embed_positions.weight"])[None, :n_pos]
    )
    out["decoder.ln_emb.weight"] = _f32(sd[f"{pre}.layernorm_embedding.weight"])
    out["decoder.ln_emb.bias"] = _f32(sd[f"{pre}.layernorm_embedding.bias"])
    out["decoder.lm_head.weight"] = _f32(
        sd.get("decoder.output_projection.weight", tok)
    )
    return out
