"""Transformer recognizer runtime (port of
``vtd_tpu/runtime/trocr_runtime.py``).

BGR crops in, ``{'text', 'confidence'}`` out; a batch of crops runs one
KV-cached greedy decode. Weights: ``model_path`` names what the
reference's loader takes (an orbax checkpoint directory, a directory or
file holding a pickled ``variables.pkl``; converted with
``convert.trocr_from_jax``) or a torch-format ``.pth`` / ``.pt`` state
dict, in the port's layout or in the HF VisionEncoderDecoder layout; its
architecture comes from a sidecar ``<ckpt>_config.json`` (or
``<ckpt>/config.json``) when no config is passed. Without a path the
weights are drawn from ``seed``.

Unlike the reference there is no zero padding to ``pad_batch``
multiples: rows are independent and PyTorch has no compile bucket to
fill. ``pad_batch`` stays as the pipeline's default chunk size.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.trocr import (
    CharTokenizer,
    TrOCR,
    TrOCRConfig,
    greedy_generate,
    init_weights_,
    load_config,
)
from ..parallel.tensor_parallel import MIN_SIZE, tensor_parallel_
from ..train.checkpoint import load_weights

logger = logging.getLogger(__name__)


class TransformerRecognizer:
    def __init__(
        self,
        model_path: Optional[str] = None,
        config: Optional[TrOCRConfig] = None,
        tokenizer=None,
        pad_batch: int = 16,
        seed: int = 0,
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or CharTokenizer()
        if config is None and model_path:
            config = self._sidecar_config(model_path)
        if config is None:
            config = TrOCRConfig(vocab_size=self.tokenizer.vocab_size)
            if self.device.type == "cpu":  # bf16 is the card's working type
                config = dataclasses.replace(config, dtype=torch.float32)
        self.cfg = config
        self.pad_batch = pad_batch
        model = TrOCR(self.cfg)
        if model_path:
            model.load_state_dict(self._load(model_path))
        else:
            init_weights_(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()

    def replica(self, devices,
                min_size: int = MIN_SIZE) -> "TransformerRecognizer":
        """This recognizer with its own copy of the model (no checkpoint
        is read) on ``devices``: one device, or a mesh row whose wide
        layers (``min_size`` as in ``tensor_parallel_``) the copy is split
        over, its activations on the row's first entry."""
        row = (list(devices) if isinstance(devices, (list, tuple))
               else [devices])
        new = copy.copy(self)
        new.device = resolve_device(row[0])
        new.model = tensor_parallel_(copy.deepcopy(self.model), row,
                                     min_size)
        return new

    @staticmethod
    def _sidecar_config(model_path: str) -> Optional[TrOCRConfig]:
        """The architecture a checkpoint carries beside it:
        ``<name>_config.json`` next to ``<name>.pt`` or next to a
        checkpoint directory ``<name>``, ``<name>.pt_config.json``, or
        ``config.json`` inside the directory."""
        p = Path(model_path)
        for cand in (
            p.parent / f"{p.stem}_config.json",
            p.parent / f"{p.name}_config.json",
            p / "config.json",
        ):
            if cand.exists():
                return load_config(str(cand))
        return None

    def _load(self, model_path: str) -> Dict[str, torch.Tensor]:
        from ..convert import trocr_from_hf_state, trocr_from_jax

        sd = load_weights(model_path, trocr_from_jax, self.cfg)
        if any(k.startswith("decoder.model.decoder.") for k in sd):
            sd = trocr_from_hf_state(
                {k: v.float().numpy() for k, v in sd.items()}, self.cfg
            )
        return sd

    # ------------------------------------------------------------------
    def _prepare(self, images: List[np.ndarray]) -> np.ndarray:
        """BGR uint8 crops -> normalised [N, H, W, 3] float32 RGB (mean/std
        0.5, the TrOCR processor's normalisation)."""
        import cv2

        h, w = self.cfg.image_size, self.cfg.width
        out = np.zeros((len(images), h, w, 3), np.float32)
        for i, img in enumerate(images):
            if img.ndim == 2:
                img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
            rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            out[i] = cv2.resize(rgb, (w, h)).astype(np.float32) / 255.0
        return (out - 0.5) / 0.5

    def recognize(self, image: np.ndarray) -> Dict[str, Any]:
        return self.recognize_batch([image])[0]

    def recognize_batch(self, images: List[np.ndarray]) -> List[Dict[str, Any]]:
        if not images:
            return []
        try:
            batch = torch.from_numpy(self._prepare(images)).to(self.device)
            texts, confs = self.recognize_crops_device(batch)
            return [
                {"text": t, "confidence": float(c)} for t, c in zip(texts, confs)
            ]
        except Exception as e:
            logger.error("Text recognition failed: %s", e)
            return [{"text": "", "confidence": 0.0}] * len(images)

    def generate(self, crops: torch.Tensor):
        """Normalised [N, H, W, 3] crops on the device -> (tokens
        [N, max_len] int32, confidences [N]) on the device."""
        return greedy_generate(
            self.model, crops,
            bos_id=self.tokenizer.BOS, eos_id=self.tokenizer.EOS,
        )

    def recognize_crops_device(
        self, crops: torch.Tensor
    ) -> Tuple[List[str], np.ndarray]:
        """Normalised [N, H, W, 3] crops -> (texts, confidences [N])."""
        if crops.shape[0] == 0:
            return [], np.zeros(0, np.float32)
        toks, confs = self.generate(crops)
        toks = toks.cpu().numpy()
        return [self.tokenizer.decode(row) for row in toks], confs.cpu().numpy()
