"""TrOCR-class transformer recognizer: ViT encoder + causal decoder (port
of ``vtd_tpu/models/trocr.py``).

``nn.Module``s with the reference's submodule names
(``encoder.block{i}.ln1/attn/ln2/mlp``, ``attn.q/k/v/o``, ``mlp.fc1/fc2``,
``decoder.tok_embed/pos_embed/ln_emb/block{i}/ln_f/lm_head``), so
``convert.trocr_from_jax`` is a rename plus transposes. Numerics follow
the reference: projections in ``cfg.dtype``; LayerNorm in float32 with
the config's eps, its output cast back before the next projection;
attention scores accumulated, masked (-1e30) and softmaxed in float32;
tanh gelu unless ``gelu_exact``; token embedding, position embeddings,
``cls_token`` and the output head in float32. The head ``lm_head`` is a
Linear of its own (not tied to ``tok_embed``), and a post-norm decoder
has no ``ln_f``.

Every matrix product here is a plain ``torch.matmul`` / ``F.linear``, as
the reference leaves them to XLA outside any kernel, but for the decode
steps' attention over the cached K/V: ``Attention.decode`` calls
``ops/decode_attention.py``, one hand-written kernel launch on the card
with the same arithmetic (the plain version on the CPU). The projections and
the patch embedding cast their weights to ``cfg.dtype`` where they are
used, as flax casts its float32 parameters to the compute dtype: the
inference paths build their weights in ``cfg.dtype`` (the casts are
no-ops), and training keeps float32 master weights (``model.float()``)
that compute in ``cfg.dtype``.

Layout: images are NHWC ``[B, H, W, 3]`` at the public functions, as in
the reference; K/V caches are ``[B, T, heads, head_dim]``.
"""
from __future__ import annotations

import copy
import json
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..obs import trace
from ..ops.decode_attention import decode_attention
from .crnn import VOCAB_CHARS

KV = Tuple[torch.Tensor, torch.Tensor]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------
class CharTokenizer:
    """Self-contained char-level tokenizer: 0=<pad>, 1=<bos>, 2=<eos>."""

    PAD, BOS, EOS = 0, 1, 2

    def __init__(self):
        self.char_to_id = {c: i + 3 for i, c in enumerate(VOCAB_CHARS)}
        self.id_to_char = {i: c for c, i in self.char_to_id.items()}
        self.vocab_size = len(self.char_to_id) + 3

    def encode(self, text: str) -> list:
        return (
            [self.BOS]
            + [self.char_to_id.get(c, self.PAD) for c in text]
            + [self.EOS]
        )

    def decode(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == self.EOS:
                break
            if i in (self.PAD, self.BOS):
                continue
            out.append(self.id_to_char.get(i, ""))
        return "".join(out)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TrOCRConfig:
    """Defaults sized like trocr-base. ``image_width`` 0 means square;
    the HF-compatibility switches (post-norm decoder, embedding LayerNorm,
    +2 position offset, erf gelu) make the module equal to the HF TrOCR
    graph (``hf_config``)."""

    image_size: int = 384
    image_width: int = 0
    patch_size: int = 16
    enc_dim: int = 768
    enc_layers: int = 12
    enc_heads: int = 12
    enc_mlp: int = 3072
    dec_dim: int = 1024
    dec_layers: int = 12
    dec_heads: int = 16
    dec_mlp: int = 4096
    vocab_size: int = 98  # CharTokenizer: 95 printable chars + pad/bos/eos
    max_len: int = 50
    dtype: Any = torch.bfloat16
    post_norm_decoder: bool = False
    layernorm_embedding: bool = False
    pos_offset: int = 0
    scale_embedding: bool = False
    head_bias: bool = True
    enc_ln_eps: float = 1e-6
    dec_ln_eps: float = 1e-6
    gelu_exact: bool = False

    @property
    def width(self) -> int:
        return self.image_width or self.image_size

    @property
    def num_patches(self) -> int:
        return (
            (self.image_size // self.patch_size)
            * (self.width // self.patch_size)
            + 1  # + CLS
        )


def small_config(**kw) -> TrOCRConfig:
    """A compact config for tests / CPU."""
    base = dict(
        image_size=64, patch_size=16, enc_dim=64, enc_layers=2, enc_heads=4,
        enc_mlp=128, dec_dim=64, dec_layers=2, dec_heads=4, dec_mlp=128,
        max_len=12, dtype=torch.float32,
    )
    base.update(kw)
    return TrOCRConfig(**base)


def hf_config(
    vocab_size: int,
    image_size: int = 384,
    patch_size: int = 16,
    enc_dim: int = 768,
    enc_layers: int = 12,
    enc_heads: int = 12,
    enc_mlp: int = 3072,
    dec_dim: int = 1024,
    dec_layers: int = 12,
    dec_heads: int = 16,
    dec_mlp: int = 4096,
    max_len: int = 50,
    scale_embedding: bool = False,
    dtype: Any = torch.float32,
) -> TrOCRConfig:
    """Config matching an HF VisionEncoderDecoder TrOCR graph (defaults
    sized like microsoft/trocr-base-*)."""
    return TrOCRConfig(
        image_size=image_size, patch_size=patch_size,
        enc_dim=enc_dim, enc_layers=enc_layers, enc_heads=enc_heads,
        enc_mlp=enc_mlp, dec_dim=dec_dim, dec_layers=dec_layers,
        dec_heads=dec_heads, dec_mlp=dec_mlp, vocab_size=vocab_size,
        max_len=max_len, dtype=dtype,
        post_norm_decoder=True, layernorm_embedding=True, pos_offset=2,
        scale_embedding=scale_embedding, head_bias=False,
        enc_ln_eps=1e-12, dec_ln_eps=1e-5, gelu_exact=True,
    )


def load_config(path: str) -> TrOCRConfig:
    """The JSON sidecar a trained checkpoint carries
    (``<ckpt>_config.json``): the dataclass fields, dtype as a string."""
    with open(path) as f:
        d = json.load(f)
    name = d.get("dtype", "float32")
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r} in {path}")
    d["dtype"] = _DTYPES[name]
    return TrOCRConfig(**d)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed and returned in float32 whatever comes in."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


def _linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``, the weights cast at use."""
    if not isinstance(layer, nn.Linear):  # split over a mesh row
        return layer(x, dtype)
    b = layer.bias
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    None if b is None else b.to(dtype))


class Attention(nn.Module):
    """Multi-head attention with an externally managed K/V cache."""

    def __init__(self, dim: int, heads: int, dtype=torch.bfloat16,
                 kv_dim: Optional[int] = None):
        super().__init__()
        kv = kv_dim or dim
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.head_dim = dim // heads
        self.q = nn.Linear(dim, dim, dtype=dtype)
        self.k = nn.Linear(kv, dim, dtype=dtype)
        self.v = nn.Linear(kv, dim, dtype=dtype)
        self.o = nn.Linear(dim, dim, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.heads, self.head_dim)

    def project_kv(self, xkv: torch.Tensor) -> KV:
        k = _linear(self.k, xkv, self.dtype)
        return self._split(k), self._split(_linear(self.v, xkv, self.dtype))

    def forward(self, xq, xkv, mask=None, kv_cache: Optional[KV] = None):
        """xq [B,Tq,D]; xkv [B,Tk,Dkv] (ignored when ``kv_cache`` is
        given); mask broadcastable to [B,H,Tq,Tk], True = attend.
        Returns (out [B,Tq,D], (k, v) [B,Tk,H,hd])."""
        q = self._split(_linear(self.q, xq, self.dtype))
        k, v = kv_cache if kv_cache is not None else self.project_kv(xkv)
        # scores accumulate in float32 from cfg.dtype operands
        attn = torch.matmul(
            q.permute(0, 2, 1, 3).float(), k.permute(0, 2, 3, 1).float()
        ) * self.head_dim ** -0.5
        if mask is not None:
            attn = torch.where(mask, attn, -1e30)
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.matmul(attn, v.permute(0, 2, 1, 3).to(self.dtype))
        b, t = xq.shape[:2]
        out = out.permute(0, 2, 1, 3).reshape(b, t, self.dim)
        return _linear(self.o, out, self.dtype), (k, v)

    def decode(self, xq, kv: KV, pos=None):
        """One query token xq [B,1,D] over a cached (k, v) [B,T,H,hd]
        -> [B,1,D]: ``forward``'s arithmetic through ``decode_attention``
        (one kernel launch on the card), attending positions <= ``pos``
        (int64 [1] on the device) or, without it, all T."""
        b = xq.shape[0]
        q = _linear(self.q, xq, self.dtype).reshape(b, self.dim)
        out = decode_attention(q, *kv, pos).reshape(b, 1, self.dim)
        return _linear(self.o, out, self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.bfloat16,
                 gelu_exact: bool = False):
        super().__init__()
        self.dtype = dtype
        self.approximate = "none" if gelu_exact else "tanh"
        self.fc1 = nn.Linear(dim, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(_linear(self.fc1, x, self.dtype),
                   approximate=self.approximate)
        return _linear(self.fc2, x, self.dtype)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        c = cfg
        self.ln1 = LayerNorm32(c.enc_dim, eps=c.enc_ln_eps)
        self.attn = Attention(c.enc_dim, c.enc_heads, c.dtype)
        self.ln2 = LayerNorm32(c.enc_dim, eps=c.enc_ln_eps)
        self.mlp = Mlp(c.enc_dim, c.enc_mlp, c.dtype, c.gelu_exact)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln1(x)
        y, _ = self.attn(y, y)
        x = x + y
        return x + self.mlp(self.ln2(x))


class ViTEncoder(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = nn.Conv2d(
            3, c.enc_dim, c.patch_size, stride=c.patch_size, dtype=c.dtype
        )
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.enc_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, c.num_patches, c.enc_dim)
        )
        self.blocks: List[EncoderBlock] = []
        for i in range(c.enc_layers):
            blk = EncoderBlock(c)
            self.add_module(f"block{i}", blk)
            self.blocks.append(blk)
        self.ln_f = LayerNorm32(c.enc_dim, eps=c.enc_ln_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] float (normalised) -> [B, N, D]; patch
        tokens in row-major order after the CLS token."""
        c = self.cfg
        pe = self.patch_embed
        x = images.to(c.dtype).permute(0, 3, 1, 2)
        if isinstance(pe, nn.Conv2d):
            x = F.conv2d(x, pe.weight.to(c.dtype), pe.bias.to(c.dtype),
                         stride=c.patch_size)
        else:  # split over a mesh row: casts at use itself
            x = pe(x, c.dtype)
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(c.dtype).expand(x.shape[0], 1, c.enc_dim)
        x = torch.cat([cls, x], 1) + self.pos_embed.to(c.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x).to(c.dtype)


class DecoderBlock(nn.Module):
    """Pre-LN natively; post-norm (attn -> add -> LN, BART order) when
    ``cfg.post_norm_decoder``. The same ln1/ln2/ln3 serve both orders."""

    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        c = self.cfg = cfg
        self.ln1 = LayerNorm32(c.dec_dim, eps=c.dec_ln_eps)
        self.self_attn = Attention(c.dec_dim, c.dec_heads, c.dtype)
        self.ln2 = LayerNorm32(c.dec_dim, eps=c.dec_ln_eps)
        self.cross_attn = Attention(
            c.dec_dim, c.dec_heads, c.dtype, kv_dim=c.enc_dim
        )
        self.ln3 = LayerNorm32(c.dec_dim, eps=c.dec_ln_eps)
        self.mlp = Mlp(c.dec_dim, c.dec_mlp, c.dtype, c.gelu_exact)

    def _layer(self, x, self_attend, cross_attend):
        if self.cfg.post_norm_decoder:
            x = self.ln1(x + self_attend(x))
            x = self.ln2(x + cross_attend(x))
            return self.ln3(x + self.mlp(x))
        x = x + self_attend(self.ln1(x))
        x = x + cross_attend(self.ln2(x))
        return x + self.mlp(self.ln3(x))

    def forward(self, x, enc_kv: KV, causal_mask):
        """Full-sequence (teacher-forced) forward."""
        return self._layer(
            x, lambda y: self.self_attn(y, y, mask=causal_mask)[0],
            lambda y: self.cross_attn(y, None, kv_cache=enc_kv)[0],
        )

    def step(self, x, self_kv: KV, enc_kv: KV, step_idx: int):
        """``step_at`` at a position given on the host, in the
        reference's call shape: -> (x, self_kv)."""
        pos = torch.tensor([step_idx], device=x.device)
        return self.step_at(x, self_kv, enc_kv, pos), self_kv

    def step_at(self, x, self_kv: KV, enc_kv: KV, pos):
        """One-token decode step at a position held on the device (``pos``
        int64 [1]), so every step is the same graph. x [B,1,D];
        ``self_kv`` (k, v) [B,Tmax,H,hd] buffers, the new K/V written in
        place with ``index_copy_``; the whole cache is attended at
        positions <= ``pos`` (the reference's mask, whose masked weights
        are exactly 0). Both attentions go through ``Attention.decode``."""
        k_cache, v_cache = self_kv

        def attend(y):
            k_new, v_new = self.self_attn.project_kv(y)
            k_cache.index_copy_(1, pos, k_new)
            v_cache.index_copy_(1, pos, v_new)
            return self.self_attn.decode(y, self_kv, pos)

        return self._layer(
            x, attend, lambda y: self.cross_attn.decode(y, enc_kv))


class TrOCRDecoder(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        c = self.cfg = cfg
        self.tok_embed = nn.Embedding(c.vocab_size, c.dec_dim)
        # HF TrOCR's learned positions carry a +2 row offset (pos_offset)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, c.max_len + c.pos_offset, c.dec_dim)
        )
        if c.layernorm_embedding:
            self.ln_emb = LayerNorm32(c.dec_dim, eps=c.dec_ln_eps)
        self.blocks: List[DecoderBlock] = []
        for i in range(c.dec_layers):
            blk = DecoderBlock(c)
            self.add_module(f"block{i}", blk)
            self.blocks.append(blk)
        # a post-norm graph ends with the last block's LayerNorm
        if not c.post_norm_decoder:
            self.ln_f = LayerNorm32(c.dec_dim, eps=c.dec_ln_eps)
        self.lm_head = nn.Linear(c.dec_dim, c.vocab_size, bias=c.head_bias)

    def project_enc_kv(self, enc: torch.Tensor) -> List[KV]:
        return [blk.cross_attn.project_kv(enc) for blk in self.blocks]

    def _embed_at(self, tokens, pos_slice):
        c = self.cfg
        x = self.tok_embed(tokens)
        if c.scale_embedding:
            x = x * (c.dec_dim ** 0.5)
        x = x + pos_slice
        if c.layernorm_embedding:
            x = self.ln_emb(x)
        return x.to(c.dtype)

    def _head(self, x):
        if not self.cfg.post_norm_decoder:
            x = self.ln_f(x)
        return self.lm_head(x.float())

    def forward(self, tokens, enc):
        """Teacher-forced forward: tokens [B,T] -> logits [B,T,V]."""
        c = self.cfg
        t = tokens.shape[1]
        x = self._embed_at(
            tokens, self.pos_embed[:, c.pos_offset:c.pos_offset + t]
        )
        causal = torch.tril(
            torch.ones(t, t, dtype=torch.bool, device=tokens.device)
        )[None, None]
        for blk, ekv in zip(self.blocks, self.project_enc_kv(enc)):
            x = blk(x, ekv, causal)
        return self._head(x)

    def step(self, token, enc_kvs: List[KV], caches: List[KV], step_idx: int):
        """``step_at`` at a position given on the host: token [B] ->
        (logits [B,V], caches), the caches returned for the reference's
        call shape."""
        pos = torch.tensor([step_idx], device=token.device)
        return self.step_at(token, enc_kvs, caches, pos), caches

    def step_at(self, token, enc_kvs: List[KV], caches: List[KV], pos):
        """One decode step at a position held on the device (int64 [1]):
        the position embedding gathered at ``pos + pos_offset``, every
        block's ``step_at``. token [B] -> logits [B,V]; the caches are
        written in place. No host read, no shape that depends on ``pos``."""
        c = self.cfg
        x = self._embed_at(
            token[:, None], self.pos_embed.index_select(1, pos + c.pos_offset)
        )
        for blk, ekv, kv in zip(self.blocks, enc_kvs, caches):
            x = blk.step_at(x, kv, ekv, pos)
        return self._head(x)[:, 0]


class TrOCR(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ViTEncoder(cfg)
        self.decoder = TrOCRDecoder(cfg)

    def forward(self, images, tokens):
        """(images, teacher-forced tokens) -> logits [B,T,V] float32."""
        return self.decoder(tokens, self.encoder(images))

    def encode(self, images):
        return self.encoder(images)

    def encode_kv(self, images) -> List[KV]:
        """images -> per-layer cross-attention (k, v) for decoding."""
        return self.decoder.project_enc_kv(self.encoder(images))

    def decode_step(self, token, enc_kvs, caches, step_idx: int):
        return self.decoder.step(token, enc_kvs, caches, step_idx)


def init_weights_(model: TrOCR, gen: torch.Generator) -> TrOCR:
    """Seeded random weights in place, drawn on the CPU from ``gen``:
    LeCun-normal projections with zero biases, normal(1/sqrt(D)) token
    embeddings, normal(0.02) position embeddings, zero ``cls_token``,
    LayerNorm at identity (flax's defaults for the reference model)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=gen) / fan_in ** 0.5
                )
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=gen)
                    / m.embedding_dim ** 0.5
                )
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        for pos in (model.encoder.pos_embed, model.decoder.pos_embed):
            pos.copy_(torch.randn(pos.shape, generator=gen) * 0.02)
        model.encoder.cls_token.zero_()
    return model


def init_decoder_cache(cfg: TrOCRConfig, batch: int, device=None) -> List[KV]:
    hd = cfg.dec_dim // cfg.dec_heads
    shape = (batch, cfg.max_len, cfg.dec_heads, hd)
    return [
        (
            torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device),
        )
        for _ in range(cfg.dec_layers)
    ]


# ---------------------------------------------------------------------------
# Greedy decode: one static-shape step, run eagerly or replayed as a graph
# ---------------------------------------------------------------------------
class DecodeState:
    """Buffers of one greedy decode of up to ``batch`` rows: the
    self-attention caches, the token, ``done``, the confidence sums and
    counts, the output tokens and the position (int64 [1]), and the
    chunk's cross-attention K/V, attended as ``start`` is given them
    (nothing is copied). Every buffer keeps its storage for the life of
    the state, so a captured step can be replayed over it. ``rows(b)``
    views the first ``b`` rows of each (the position is shared), so
    steps of every row count write the same storage."""

    def __init__(self, cfg: TrOCRConfig, batch: int, device=None):
        self.enc_kvs: List[KV] = []
        self.caches = init_decoder_cache(cfg, batch, device)
        self.token = torch.zeros(batch, dtype=torch.int32, device=device)
        self.done = torch.zeros(batch, dtype=torch.bool, device=device)
        self.psum = torch.zeros(batch, dtype=torch.float32, device=device)
        self.pcnt = torch.zeros(batch, dtype=torch.int32, device=device)
        self.toks = torch.zeros((batch, cfg.max_len), dtype=torch.int32,
                                device=device)
        self.pos = torch.zeros(1, dtype=torch.int64, device=device)

    def rows(self, b: int) -> "DecodeState":
        new = copy.copy(self)
        new.caches = [(k[:b], v[:b]) for k, v in self.caches]
        for name in ("token", "done", "psum", "pcnt", "toks"):
            setattr(new, name, getattr(self, name)[:b])
        return new

    def start(self, enc_kvs: List[KV], bos_id: int = 1) -> None:
        """A new chunk, on the device: its cross-attention K/V (from
        ``TrOCR.encode_kv``, the state's row count) attended from here on,
        the caches zeroed, every row at <bos>, not done, at position 0."""
        self.enc_kvs = enc_kvs
        for k, v in self.caches:
            k.zero_()
            v.zero_()
        self.token.fill_(bos_id)
        self.done.zero_()
        self.psum.zero_()
        self.pcnt.zero_()
        self.pos.zero_()

    def confidences(self) -> torch.Tensor:
        """Mean token probability [B] of the decode so far (a new tensor)."""
        return self.psum / self.pcnt.clamp(min=1)


@torch.inference_mode()
def greedy_step_(model: TrOCR, state: DecodeState, eos_id: int = 2) -> None:
    """One greedy decoder step on ``state``'s buffers, in place, at the
    position ``state.pos`` holds, which it advances. Finished rows emit
    <pad> and stop accumulating confidence (the step that emits <eos>
    still counts). It allocates nothing that outlives it and reads
    nothing back, so it can be captured once and replayed ``max_len``
    times."""
    logits = model.decoder.step_at(
        state.token, state.enc_kvs, state.caches, state.pos
    )
    pmax, nxt = torch.softmax(logits, dim=-1).max(dim=-1)
    token = torch.where(state.done, 0, nxt.to(torch.int32))
    state.psum.add_(torch.where(state.done, 0.0, pmax))
    state.pcnt.add_((~state.done).to(torch.int32))
    state.done.logical_or_(token == eos_id)
    state.token.copy_(token)
    state.toks.index_copy_(1, state.pos, token[:, None])
    state.pos.add_(1)


@torch.inference_mode()
def greedy_decode(
    model: TrOCR, enc_kvs: List[KV], bos_id: int = 1, eos_id: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All ``max_len`` greedy decoder steps over per-layer cross-attention
    K/V (from ``model.encode_kv``) -> (tokens [B, max_len] int32, mean
    token probability [B]): ``greedy_step_`` run eagerly on a
    ``DecodeState`` of these rows, which never waits for the device."""
    b, dev = enc_kvs[0][0].shape[0], enc_kvs[0][0].device
    state = DecodeState(model.cfg, b, dev)
    state.start(enc_kvs, bos_id)
    for _ in range(model.cfg.max_len):
        with trace.span("vtd.trocr_step", b):
            greedy_step_(model, state, eos_id)
    return state.toks, state.confidences()


@torch.inference_mode()
def greedy_generate(
    model: TrOCR, images: torch.Tensor, bos_id: int = 1, eos_id: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy decode: images [B, H, W, 3] -> (tokens [B, max_len]
    int32, mean token probability [B]). The encoder and the
    cross-attention K/V run once, then ``greedy_decode``."""
    return greedy_decode(model, model.encode_kv(images), bos_id, eos_id)
