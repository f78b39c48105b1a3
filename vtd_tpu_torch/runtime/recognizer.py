"""Batched text recognizer (port of ``vtd_tpu/runtime/recognizer.py``):
a facade over the CRNN + greedy CTC and the transformer (TrOCR-class)
recognizers, chosen by ``use_transformer``.

``recognize`` / ``recognize_batch`` return ``{'text', 'confidence'}``;
``recognize_crops_device`` takes normalised crops that are already on
the device ([N, 32, 128, 3] for the CRNN, [N, image_size, width, 3] for
the transformer). The native beam decoder waits for a later slice of the
port.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import (
    compute_dtype, load_state_dict, resolve_device, seeded_init_,
)
from ..models.crnn import CRNN, build_vocab
from ..ops.ctc import ctc_greedy_decode_arrays, ids_to_text

logger = logging.getLogger(__name__)


class TextRecognizer:
    """Facade over the CRNN and transformer recognizers.

    ``model_path``: a torch-format state dict of the port's ``CRNN`` or
    ``TrOCR`` (``convert.crnn_from_jax`` / ``convert.trocr_from_jax``
    make one from ``vtd_tpu`` weights); without one, weights are drawn
    from ``seed``. ``use_transformer`` defaults to False here (the
    reference defaults to True) until serving is wired to the port.
    """

    def __init__(
        self,
        model_path: Optional[str] = None,
        use_transformer: bool = False,
        seed: int = 0,
        decoder: str = "greedy",
        dtype: Optional[torch.dtype] = None,
        device: str = "cuda",
        transformer_config=None,
    ):
        self.use_transformer = use_transformer
        self.vocab = build_vocab()
        if use_transformer:
            from .trocr_runtime import TransformerRecognizer

            self.device = resolve_device(device)
            self.transformer = TransformerRecognizer(
                model_path=model_path, config=transformer_config, seed=seed,
                device=device,
            )
            self.crnn = None
            return
        self.transformer = None
        if decoder != "greedy":
            raise NotImplementedError(
                "the native CTC beam decoder waits for a later slice of "
                "the port; use decoder='greedy'"
            )
        self.device = resolve_device(device)
        crnn = CRNN(dtype=compute_dtype(self.device, dtype))
        if model_path:
            crnn.load_state_dict(load_state_dict(model_path))
        else:
            seeded_init_(crnn, seed)
        self.crnn = crnn.to(self.device).eval()

    def logits(self, crops: torch.Tensor) -> torch.Tensor:
        """[N, 32, 128, 3] float crops in [0, 1] (NHWC) -> [N, 31, 97]."""
        return self.crnn(crops.permute(0, 3, 1, 2))

    # ------------------------------------------------------------------
    def recognize(self, image: np.ndarray) -> Dict[str, Any]:
        return self.recognize_batch([image])[0]

    def recognize_batch(self, images: List[np.ndarray]) -> List[Dict[str, Any]]:
        """Ragged uint8 BGR crops -> [{'text', 'confidence'}]."""
        if not images:
            return []
        if self.use_transformer:
            return self.transformer.recognize_batch(images)
        try:
            import cv2

            batch = np.zeros((len(images), 32, 128, 3), np.float32)
            for i, img in enumerate(images):
                if img.ndim == 2:
                    img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
                batch[i] = cv2.resize(img, (128, 32)).astype(np.float32) / 255.0
            texts, confs = self.recognize_crops_device(
                torch.from_numpy(batch).to(self.device)
            )
            return [
                {"text": t, "confidence": float(c)} for t, c in zip(texts, confs)
            ]
        except Exception as e:
            logger.error("CRNN batch recognition failed: %s", e)
            return [{"text": "", "confidence": 0.0}] * len(images)

    @torch.inference_mode()
    def recognize_crops_device(
        self, crops: torch.Tensor
    ) -> Tuple[List[str], np.ndarray]:
        """Normalised crops on the device -> (texts, confidences)."""
        if self.use_transformer:
            return self.transformer.recognize_crops_device(crops)
        arrs = ctc_greedy_decode_arrays(self.logits(crops))
        ids = arrs["ids"].cpu().numpy()
        emit = arrs["emit"].cpu().numpy()
        return ids_to_text(ids, emit), arrs["confidence"].cpu().numpy()
