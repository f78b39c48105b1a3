"""TrOCR-class transformer recognizer training (port of
``vtd_tpu/train/trocr_trainer.py``).

Teacher-forced cross-entropy on synthetic text-line crops, AdamW under a
linear-warmup cosine schedule, greedy-decode exact-match evaluation, and
a checkpoint with its ``_config.json`` sidecar, so that
``TransformerRecognizer(model_path=...)`` rebuilds the exact model.

The model trains with float32 master weights (``TrOCR(cfg).float()``)
and computes in ``cfg.dtype``: the projections cast their weights at
use, as flax casts its float32 parameters (``models/trocr.py``). AdamW on
bf16 weights would lose most updates. Checkpoints hold the float32
weights; a loader casts them to its model's dtype.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..models.trocr import (
    CharTokenizer,
    TrOCR,
    TrOCRConfig,
    greedy_generate,
    init_weights_,
    load_config,
)
from .checkpoint import load_weights, save_state_dict
from .recognizer_trainer import photometric_jitter, synthesize_text_lines

logger = logging.getLogger(__name__)

__all__ = [
    "TrOCRTrainer", "demo_config", "encode_tokens", "load_config",
    "make_trocr_train_step", "pack_u8", "save_config",
    "synthesize_trocr_crops", "warmup_cosine",
]


def demo_config(
    image_size: int = 48, image_width: int = 192, **kw
) -> TrOCRConfig:
    """A compact TrOCR (about 4M parameters) that trains to useful
    accuracy in minutes on one card, on text-shaped 48x192 crops."""
    tok = CharTokenizer()
    base = dict(
        image_size=image_size, image_width=image_width, patch_size=8,
        enc_dim=128, enc_layers=4, enc_heads=4, enc_mlp=256,
        dec_dim=128, dec_layers=4, dec_heads=4, dec_mlp=256,
        vocab_size=tok.vocab_size, max_len=16, dtype=torch.float32,
    )
    base.update(kw)
    return TrOCRConfig(**base)


def save_config(path: str, cfg: TrOCRConfig) -> None:
    """The JSON sidecar ``models.trocr.load_config`` reads: the dataclass
    fields, dtype by name."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).replace("torch.", "")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def synthesize_trocr_crops(
    n: int, cfg: TrOCRConfig, seed: int = 0,
    length_range: Tuple[int, int] = (3, 9),
) -> Tuple[np.ndarray, List[str]]:
    """[n, H, W, 3] crops normalised with mean/std 0.5 (the inference
    normalisation) and their strings."""
    images, texts = synthesize_text_lines(
        n, seed=seed, height=cfg.image_size, width=cfg.width,
        length_range=length_range,
    )
    return (images - 0.5) / 0.5, texts


def encode_tokens(
    texts: List[str], tok: CharTokenizer, max_len: int
) -> np.ndarray:
    """Strings -> [B, max_len+1] (<bos> text <eos> <pad>...), one longer
    than max_len so inputs and targets both span max_len steps. Texts are
    cut to max_len-1 characters so that every row keeps its <eos>."""
    out = np.zeros((len(texts), max_len + 1), np.int32)  # 0 == <pad>
    for i, t in enumerate(texts):
        ids = tok.encode(t[: max_len - 1])  # [bos] + chars + [eos]
        out[i, : len(ids)] = ids
    return out


def warmup_cosine(step: int, peak: float, warmup: int, total: int,
                  init: float = 0.0) -> float:
    """optax's ``warmup_cosine_decay_schedule(init, peak, warmup, total)``
    at ``step``: a linear ramp from ``init`` (exactly ``init`` at step 0),
    then a cosine from ``peak`` to 0 over ``total - warmup`` steps."""
    if step < warmup:
        frac = 1.0 - step / warmup
        return (init - peak) * frac + peak
    decay = total - warmup
    count = min(step - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * count / decay))


def make_trocr_train_step(
    model: TrOCR, optimizer: torch.optim.Optimizer,
    schedule: Optional[Callable[[int], float]] = None,
    augment: bool = False, generator: Optional[torch.Generator] = None,
) -> Callable[..., torch.Tensor]:
    """``step(images, tokens [B, max_len+1]) -> loss`` (a 0-d tensor on the
    device). ``images`` are [B, H, W, 3] uint8 (normalised on the device,
    ``/127.5 - 1``) or normalised floats. The loss is the cross-entropy
    over the non-<pad> targets. ``schedule(n)`` sets the learning rate
    of the n-th update (counted from 0); ``augment=True`` jitters the
    normalised crops (contrast 0.75-1.25, brightness +-0.25, noise 0.06)
    from ``generator``. The step's gradients stay in ``.grad`` until the
    next step clears them."""
    if augment and generator is None:
        raise ValueError("augment=True needs a torch.Generator")
    count = [0]

    def step(images: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 127.5 - 1.0
        if augment:
            images = photometric_jitter(images, generator, 0.25, 0.25, 0.06)
        tokens = tokens.long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        mask = (targets != CharTokenizer.PAD).to(torch.float32)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(images, inputs)
        ce = F.cross_entropy(
            logits.flatten(0, 1).float(), targets.flatten(), reduction="none"
        ).view_as(mask)
        loss = (ce * mask).sum() / mask.sum().clamp(min=1.0)
        loss.backward()
        if schedule is not None:
            lr = schedule(count[0])
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        count[0] += 1
        return loss.detach()

    return step


def pack_u8(imgs: np.ndarray) -> np.ndarray:
    """Normalised [-1, 1] float crops -> uint8 for the upload (the train
    step normalises on the device)."""
    if imgs.dtype == np.uint8:
        return imgs
    return np.clip((imgs + 1.0) * 127.5 + 0.5, 0.0, 255.0).astype(np.uint8)


class TrOCRTrainer:
    """config keys: checkpoint_dir, max_epochs, learning_rate,
    weight_decay, batch_size, warmup_steps, seed, augment, save_every,
    init_from."""

    def __init__(self, config: Dict[str, Any],
                 model_config: Optional[TrOCRConfig] = None,
                 device: str = "cuda"):
        self.config = dict(config)
        self.model_config = model_config or demo_config()
        self.tokenizer = CharTokenizer()
        self.device = resolve_device(device)

    def build_model(self) -> TrOCR:
        """Float32 master weights drawn from the config's seed, or read from
        ``init_from`` (a port ``.pt``, or the JAX package's checkpoint
        carried across by ``convert.trocr_from_jax``)."""
        from ..convert import trocr_from_jax

        mc = self.model_config
        model = TrOCR(mc).float()
        init_from = self.config.get("init_from")
        if init_from:
            model.load_state_dict(load_weights(str(init_from), trocr_from_jax,
                                               mc))
        else:
            gen = torch.Generator().manual_seed(int(self.config.get("seed", 0)))
            init_weights_(model, gen)
        return model.to(self.device)

    def train(
        self,
        images: np.ndarray,
        texts: List[str],
        val_images: Optional[np.ndarray] = None,
        val_texts: Optional[List[str]] = None,
        data_fn: Optional[Callable[[int], Tuple[np.ndarray, List[str]]]] = None,
    ) -> Dict[str, Any]:
        """``data_fn(epoch) -> (images, texts)``: when given, each epoch
        after the first trains on a fresh draw, rendered on a background
        thread while the card trains the epoch before."""
        cfg = self.config
        mc = self.model_config
        dev = self.device
        pool = None
        try:
            model = self.build_model()
            batch_size = int(cfg.get("batch_size", 32))
            lr = float(cfg.get("learning_rate", 3e-4))
            warmup = int(cfg.get("warmup_steps", 100))
            max_epochs = int(cfg.get("max_epochs", 10))
            total = max(warmup + 1, max_epochs * (len(images) // batch_size))
            optimizer = torch.optim.AdamW(
                model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=float(cfg.get("weight_decay", 1e-4)),
            )
            seed = int(cfg.get("seed", 0))
            step = make_trocr_train_step(
                model, optimizer,
                schedule=lambda n: warmup_cosine(n, lr, warmup, total),
                augment=bool(cfg.get("augment", True)),
                generator=torch.Generator(device=dev).manual_seed(seed + 7),
            )

            tokens = encode_tokens(texts, self.tokenizer, mc.max_len)
            images = pack_u8(images)
            n = len(images)
            save_every = int(cfg.get("save_every", 10))
            ckpt_dir = Path(cfg.get("checkpoint_dir", "./checkpoints"))
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            sidecar = str(ckpt_dir / "trocr_final_config.json")
            history = []
            prefetch = None
            if data_fn is not None:
                from concurrent.futures import ThreadPoolExecutor

                pool = ThreadPoolExecutor(1)
            for epoch in range(max_epochs):
                t0 = time.time()
                if pool is not None:
                    if prefetch is not None:
                        images, texts = prefetch.result()
                        images = pack_u8(images)
                        tokens = encode_tokens(
                            texts, self.tokenizer, mc.max_len
                        )
                        n = len(images)
                    # no draw past the last epoch: it would never be used
                    prefetch = (pool.submit(data_fn, epoch + 1)
                                if epoch + 1 < max_epochs else None)
                perm = np.random.default_rng(epoch).permutation(n)
                losses = []
                for i in range(0, n - batch_size + 1, batch_size):
                    sel = perm[i:i + batch_size]
                    loss = step(torch.from_numpy(images[sel]).to(dev),
                                torch.from_numpy(tokens[sel]).to(dev))
                    losses.append(float(loss))
                rec = {
                    "epoch": epoch,
                    "train_loss": float(np.mean(losses)),
                    "epoch_seconds": time.time() - t0,
                }
                if val_images is not None:
                    rec.update(self.evaluate(model, val_images, val_texts))
                history.append(rec)
                logger.info("epoch %d: %s", epoch, rec)
                if save_every and (epoch + 1) % save_every == 0:
                    # two autosave slots in turn, so that a kill during a
                    # save leaves the other one whole
                    slot = ((epoch + 1) // save_every) % 2
                    auto = save_state_dict(
                        ckpt_dir / f"trocr_autosave_{'ab'[slot]}.pt", model)
                    save_config(sidecar, mc)
                    (ckpt_dir / "autosave_latest.txt").write_text(
                        f"{auto}\nepoch={epoch}\n"
                    )

            path = save_state_dict(ckpt_dir / "trocr_final.pt", model)
            save_config(sidecar, mc)
            return {
                "status": "success",
                "best_model_path": path,
                "final_loss": history[-1]["train_loss"],
                "epochs_trained": len(history),
                "history": history,
            }
        except Exception as e:
            logger.error("TrOCR training failed: %s", e)
            return {"status": "failed", "error": str(e)}
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def evaluate(
        self, model: TrOCR, images: np.ndarray, texts: List[str],
        batch: int = 64,
    ) -> Dict[str, float]:
        """Greedy decode of normalised crops in chunks of ``batch`` ->
        exact match and character accuracy. Rows decode independently, so
        the last chunk is not padded as the reference pads it."""
        tok = self.tokenizer
        model.eval()
        decoded: List[str] = []
        for i in range(0, len(images), batch):
            chunk = torch.from_numpy(
                np.asarray(images[i:i + batch], np.float32)).to(self.device)
            toks, _ = greedy_generate(model, chunk, bos_id=tok.BOS,
                                      eos_id=tok.EOS)
            decoded.extend(tok.decode(r) for r in toks.cpu().numpy())
        exact = sum(d == t for d, t in zip(decoded, texts)) / max(len(texts), 1)
        char_correct = sum(
            sum(a == b for a, b in zip(d, t)) for d, t in zip(decoded, texts)
        )
        char_total = sum(max(len(t), 1) for t in texts)
        return {
            "val_exact_match": exact,
            "val_char_accuracy": char_correct / max(char_total, 1),
        }
