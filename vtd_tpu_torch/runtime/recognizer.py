"""Batched text recognizer (port of ``vtd_tpu/runtime/recognizer.py``):
a facade over the CRNN + greedy CTC and the transformer (TrOCR-class)
recognizers, chosen by ``use_transformer``.

``recognize`` / ``recognize_batch`` return ``{'text', 'confidence'}``;
``recognize_crops_device`` takes normalised crops that are already on
the device ([N, 32, 128, 3] for the CRNN, [N, image_size, width, 3] for
the transformer). ``decoder="beam"`` runs the CRNN on the card, takes
the log-softmax there and decodes on the host with the C++ prefix beam
(``native/ctc_beam.cpp``).
"""
from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import compute_dtype, resolve_device, seeded_init_
from ..models.crnn import CRNN, ID_TO_CHAR, build_vocab
from ..ops.ctc import ctc_greedy_decode_arrays, ids_to_text
from ..parallel.tensor_parallel import MIN_SIZE, tensor_parallel_
from ..train.checkpoint import load_weights

logger = logging.getLogger(__name__)


class TextRecognizer:
    """Facade over the CRNN and transformer recognizers.

    ``model_path``: what the reference's loader takes (an orbax
    checkpoint directory, a directory or file holding a pickled
    ``variables.pkl``, both converted with ``convert.crnn_from_jax`` /
    ``convert.trocr_from_jax``), or a torch-format ``.pth``/``.pt`` state
    dict of the port's model; without one, weights are drawn from
    ``seed``. ``use_transformer`` defaults to True, as in the reference.

    ``pad_batch`` is accepted for the reference's keywords and ignored:
    it pads to XLA compile buckets, which PyTorch does not have.
    ``decoder``: ``"greedy"`` (CTC collapse on the card) or ``"beam"``
    (prefix beam of ``beam_width`` on the host, CRNN only).
    """

    def __init__(
        self,
        model_path: Optional[str] = None,
        use_transformer: bool = True,
        pad_batch: int = 128,
        seed: int = 0,
        transformer_config=None,
        decoder: str = "greedy",
        beam_width: int = 8,
        dtype: Optional[torch.dtype] = None,
        device: str = "cuda",
    ):
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"unknown decoder {decoder!r}")
        self.use_transformer = use_transformer
        self.vocab = build_vocab()
        self.pad_batch = pad_batch
        self.decoder = decoder
        self.beam_width = beam_width
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
        self.device = resolve_device(device)
        crnn = CRNN(dtype=compute_dtype(self.device, dtype))
        if not model_path:
            seeded_init_(crnn, seed)
        self.crnn = crnn.to(self.device).eval()
        if model_path:
            self.crnn.load_state_dict(self.load_model(model_path))

    def load_model(self, model_path: str) -> Dict[str, torch.Tensor]:
        """The CRNN state dict of a checkpoint, on the recognizer's
        device, in the stored types: a torch file (a ``.pth``/``.pt``
        name or a zip archive by its content; the original app's CRNN
        keys are the port's), an orbax checkpoint directory, or a
        directory or file holding a pickled ``variables.pkl`` (both
        converted with ``convert.crnn_from_jax``)."""
        from ..convert import crnn_from_jax

        try:
            sd = load_weights(model_path, crnn_from_jax)
        except Exception as e:
            logger.error("Failed to load CRNN model: %s", e)
            raise
        return {k: v.to(self.device) for k, v in sd.items()}

    def replica(self, devices, min_size: int = MIN_SIZE) -> "TextRecognizer":
        """This recognizer with its own copy of the model (no checkpoint
        is read) on ``devices``: one device, or a mesh row whose wide
        layers (``min_size`` as in ``tensor_parallel_``) the copy is split
        over, its activations on the row's first entry."""
        row = (list(devices) if isinstance(devices, (list, tuple))
               else [devices])
        new = copy.copy(self)
        new.device = resolve_device(row[0])
        if self.use_transformer:
            new.transformer = self.transformer.replica(row, min_size)
        else:
            new.crnn = tensor_parallel_(copy.deepcopy(self.crnn), row,
                                        min_size)
        return new

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
        if self.decoder == "beam":
            return self._beam_decode(crops)
        arrs = ctc_greedy_decode_arrays(self.logits(crops))
        ids = arrs["ids"].cpu().numpy()
        emit = arrs["emit"].cpu().numpy()
        return ids_to_text(ids, emit), arrs["confidence"].cpu().numpy()

    def log_probs(self, crops: torch.Tensor) -> torch.Tensor:
        """[N, 32, 128, 3] crops -> float32 CTC log-probs [N, 31, 97], on
        the crops' device."""
        return torch.log_softmax(self.logits(crops).to(torch.float32), -1)

    def _beam_decode(self, crops: torch.Tensor):
        """CTC prefix beam search on the host (C++) over the card's
        log-probs; a beam score is the log-prob of the whole labelling,
        mapped to (0, 1] per emitted character as the reference does."""
        from ..native import ctc_beam_decode

        if crops.shape[0] == 0:
            return [], np.zeros(0, np.float32)
        lp = self.log_probs(crops).cpu().numpy()
        seqs, scores = ctc_beam_decode(lp, beam_width=self.beam_width)
        texts = [
            "".join(
                ID_TO_CHAR.get(i, "") for i in seq
                if len(ID_TO_CHAR.get(i, "")) == 1
            )
            for seq in seqs
        ]
        confs = np.exp(
            np.clip(scores / np.maximum([len(s) for s in seqs], 1), -20, 0)
        )
        return texts, confs.astype(np.float32)
