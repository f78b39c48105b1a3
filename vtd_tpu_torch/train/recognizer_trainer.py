"""CRNN recognizer training with the CTC loss (port of
``vtd_tpu/train/recognizer_trainer.py``).

CTC over the CRNN's per-timestep logits, AdamW, greedy-decode exact-match
and character accuracy, and the reference's synthetic text-line
generator (cv2-rendered strings, the same numpy seeds). The final
checkpoint is the port's ``crnn_final.pt`` state dict, which
``TextRecognizer(model_path=..., use_transformer=False)`` loads as it is.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device, seeded_init_
from ..models.crnn import BLANK_ID, CRNN, CRNN_VOCAB
from ..ops.ctc import ctc_greedy_decode_arrays, ids_to_text
from .checkpoint import save_state_dict

logger = logging.getLogger(__name__)

MAX_LABEL_LEN = 15  # CRNN emits T=31 steps; CTC needs len <= (T+1)/2 repeats


def encode_labels(
    texts: List[str], max_len: int = MAX_LABEL_LEN
) -> Tuple[np.ndarray, np.ndarray]:
    """Strings -> (labels [B, L] int32 padded with blank, paddings [B, L]
    float32, 1.0 on padding)."""
    labels = np.zeros((len(texts), max_len), np.int32)
    padding = np.ones((len(texts), max_len), np.float32)
    for i, t in enumerate(texts):
        ids = [CRNN_VOCAB.get(c, CRNN_VOCAB["<unk>"]) for c in t[:max_len]]
        labels[i, : len(ids)] = ids
        padding[i, : len(ids)] = 0.0
    return labels, padding


def synthesize_text_lines(
    n: int, seed: int = 0, height: int = 32, width: int = 128,
    length_range: Tuple[int, int] = (3, 9),
) -> Tuple[np.ndarray, List[str]]:
    """Random strings rendered into [n, height, width, 3] float crops in
    [0, 1], byte-equal to the reference's for the same seed: text at a
    random scale, cut to its tight box with a few pixels of jittered
    padding, then resized (aspect-distorting) to the recognizer's input,
    as a detected region is."""
    import cv2

    rng = np.random.default_rng(seed)
    chars = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    images = np.zeros((n, height, width, 3), np.float32)
    texts = []
    for i in range(n):
        length = int(rng.integers(*length_range))
        text = "".join(rng.choice(list(chars)) for _ in range(length))
        scale = float(rng.uniform(0.8, 2.2))
        thick = int(rng.integers(1, 3)) if scale < 1.5 else int(rng.integers(2, 4))
        (tw, th), base = cv2.getTextSize(
            text, cv2.FONT_HERSHEY_SIMPLEX, scale, thick
        )
        margin = 20
        canvas = np.full(
            (th + base + 2 * margin, tw + 2 * margin, 3),
            int(rng.integers(180, 255)), np.uint8,
        )
        cv2.putText(
            canvas, text, (margin, margin + th),
            cv2.FONT_HERSHEY_SIMPLEX, scale, (0, 0, 0), thick,
        )
        px0 = margin - int(rng.integers(0, 6))
        py0 = margin - int(rng.integers(0, 6))
        px1 = margin + tw + int(rng.integers(0, 6))
        py1 = margin + th + base + int(rng.integers(0, 6))
        crop = canvas[max(py0, 0):py1, max(px0, 0):px1]
        images[i] = (
            cv2.resize(crop, (width, height), interpolation=cv2.INTER_LINEAR)
            .astype(np.float32) / 255.0
        )
        texts.append(text)
    return images, texts


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_pad: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of each sequence's CTC negative
    log-likelihood (``jnp.mean(optax.ctc_loss(...))``); every logit step
    is real. ``reduction="mean"`` would divide each sequence by its
    target length first, which is another loss.

    On an infeasible alignment (a label longer than the steps allow)
    optax clamps at its ``log_epsilon`` and returns a large finite loss
    where this returns ``inf``; labels of at most ``MAX_LABEL_LEN`` = 15
    against T = 31 never give one, and the synthetic data has at most 8
    characters."""
    b, t, _ = logits.shape
    log_probs = torch.log_softmax(logits.to(torch.float32), -1)
    target_lengths = (label_pad < 0.5).sum(1)
    input_lengths = torch.full((b,), t, dtype=torch.long,
                               device=logits.device)
    return F.ctc_loss(
        log_probs.transpose(0, 1), labels.long(), input_lengths,
        target_lengths, blank=BLANK_ID, reduction="none",
    ).mean()


def photometric_jitter(images: torch.Tensor, gen: torch.Generator,
                       contrast: float, brightness: float,
                       noise: float) -> torch.Tensor:
    """Per-sample contrast ~ U(1 - c, 1 + c) and brightness ~ U(-b, b) on
    [B, ...] images, plus gaussian noise of std ``noise``, drawn from
    ``gen`` on the images' device (the reference's distributions; its
    draws come from a JAX key, so the samples differ)."""
    b = images.shape[0]
    shape = (b,) + (1,) * (images.dim() - 1)
    dev = images.device
    c = torch.rand(shape, generator=gen, device=dev) * (2 * contrast) + (
        1.0 - contrast)
    br = torch.rand(shape, generator=gen, device=dev) * (2 * brightness) - (
        brightness)
    n = noise * torch.randn(images.shape, generator=gen, device=dev)
    return images * c + br + n


def make_crnn_train_step(
    model: CRNN, optimizer: torch.optim.Optimizer, augment: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Callable[..., torch.Tensor]:
    """``step(images [B,32,128,3] in [0,1], labels [B,L], label_pad [B,L])
    -> loss`` (a 0-d tensor on the device). ``augment=True`` jitters the
    crops on the device (contrast 0.8-1.2, brightness +-0.12, noise 0.03,
    clipped to [0, 1]) from ``generator``. The step's gradients stay in
    ``.grad`` until the next step clears them."""
    if augment and generator is None:
        raise ValueError("augment=True needs a torch.Generator")

    def step(images, labels, label_pad):
        if augment:
            images = photometric_jitter(
                images, generator, 0.2, 0.12, 0.03).clamp(0.0, 1.0)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = ctc_loss(model(images.permute(0, 3, 1, 2)), labels, label_pad)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


class RecognizerTrainer:
    """config keys: checkpoint_dir, max_epochs, learning_rate,
    weight_decay, batch_size, augment, seed."""

    def __init__(self, config: Dict[str, Any], device: str = "cuda"):
        self.config = dict(config)
        self.device = resolve_device(device)

    def train(
        self,
        images: np.ndarray,
        texts: List[str],
        val_images: Optional[np.ndarray] = None,
        val_texts: Optional[List[str]] = None,
    ) -> Dict[str, Any]:
        cfg = self.config
        dev = self.device
        try:
            seed = int(cfg.get("seed", 0))
            model = seeded_init_(CRNN(dtype=torch.float32), seed).to(dev)
            batch_size = int(cfg.get("batch_size", 32))
            optimizer = torch.optim.AdamW(
                model.parameters(), lr=float(cfg.get("learning_rate", 1e-3)),
                betas=(0.9, 0.999), eps=1e-8,
                weight_decay=float(cfg.get("weight_decay", 1e-5)),
            )
            gen = torch.Generator(device=dev).manual_seed(seed + 11)
            step = make_crnn_train_step(
                model, optimizer, augment=bool(cfg.get("augment", True)),
                generator=gen,
            )
            labels, pads = encode_labels(texts)
            n = len(images)
            max_epochs = int(cfg.get("max_epochs", 10))
            history = []
            for epoch in range(max_epochs):
                t0 = time.time()
                perm = np.random.default_rng(epoch).permutation(n)
                losses = []
                for i in range(0, n - batch_size + 1, batch_size):
                    sel = perm[i:i + batch_size]
                    loss = step(
                        torch.from_numpy(images[sel]).to(dev),
                        torch.from_numpy(labels[sel]).to(dev),
                        torch.from_numpy(pads[sel]).to(dev),
                    )
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

            ckpt_dir = Path(cfg.get("checkpoint_dir", "./checkpoints"))
            path = save_state_dict(ckpt_dir / "crnn_final.pt", model)
            return {
                "status": "success",
                "best_model_path": path,
                "final_loss": history[-1]["train_loss"],
                "epochs_trained": max_epochs,
                "history": history,
            }
        except Exception as e:
            logger.error("Recognizer training failed: %s", e)
            return {"status": "failed", "error": str(e)}

    @torch.no_grad()
    def evaluate(self, model: CRNN, images: np.ndarray,
                 texts: List[str]) -> Dict[str, float]:
        """Greedy CTC decode of ``images`` in eval mode -> exact match and
        character accuracy."""
        model.eval()
        x = torch.from_numpy(np.asarray(images, np.float32)).to(self.device)
        arrs = ctc_greedy_decode_arrays(model(x.permute(0, 3, 1, 2)))
        decoded = ids_to_text(arrs["ids"].cpu().numpy(),
                              arrs["emit"].cpu().numpy())
        exact = sum(d == t for d, t in zip(decoded, texts)) / max(len(texts), 1)
        char_correct = 0
        char_total = 0
        for d, t in zip(decoded, texts):
            char_total += max(len(t), 1)
            char_correct += sum(a == b for a, b in zip(d, t))
        return {
            "val_exact_match": exact,
            "val_char_accuracy": char_correct / max(char_total, 1),
        }
