"""Batched text detector (port of ``vtd_tpu/runtime/detector.py``).

``detect(image, thresh) -> [{bbox, confidence, polygon}]``: one device
program per frame batch (optional I420 unpack -> preprocess -> DBNet
probability branch -> DB postprocess); only a [B, K, 28] uint8 pack of
float16 boxes, polygons, scores and validity comes back to the host.
"""
from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.device import compute_dtype, resolve_device, seeded_init_
from ..models.dbnet import DBNet
from ..ops.db_postprocess import db_postprocess, extract_detections
from ..ops.preprocess import preprocess_frames, yuv420_to_bgr
from ..parallel.tensor_parallel import MIN_SIZE, tensor_parallel_
from ..train.checkpoint import load_weights, save_state_dict

logger = logging.getLogger(__name__)


class TextDetector:
    """DBNet detector with a batched device path.

    ``model_path``: whatever :meth:`load_model` takes; without one,
    weights are drawn from ``seed``.
    """

    def __init__(
        self,
        model_path: Optional[str] = None,
        input_size: int = 640,
        max_dets: int = 64,
        max_box_frac: float = 0.95,
        dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        transfer_format: str = "bgr",
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        self.input_size = input_size
        self.max_dets = max_dets
        self.max_box_frac = max_box_frac
        if transfer_format not in ("bgr", "yuv420"):
            raise ValueError(f"unknown transfer_format {transfer_format!r}")
        self.transfer_format = transfer_format
        self.dtype = compute_dtype(self.device, dtype)
        self.seed = seed
        model = DBNet()
        if not model_path:
            seeded_init_(model, seed)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        if model_path:
            self.model.load_state_dict(self.load_model(model_path))

    def load_model(self, model_path: str) -> Dict[str, torch.Tensor]:
        """The state dict of a checkpoint, on the detector's device, in
        the stored types. Takes what the reference's loader takes:

          * a torch file (a ``.pth``/``.pt`` name or a zip archive by its
            content, such as :meth:`save_model` writes under any name),
            keyed as the port's ``DBNet`` or as the original app's DBNet
            (``{'model_state_dict': ...}``; carried across by
            ``convert.dbnet_from_app_state``, which raises on a partial
            backbone or head branch; the FPN, and a part the file lacks
            altogether, come from the port's init drawn from ``seed``);
          * an orbax checkpoint directory, or a directory or file holding
            a pickled ``variables.pkl``, converted with
            ``convert.dbnet_from_jax``.
        """
        from ..convert import (
            dbnet_from_app_state, dbnet_from_jax, is_app_dbnet_state,
        )

        try:
            sd = load_weights(model_path, dbnet_from_jax)
            if is_app_dbnet_state(sd):
                sd = {**seeded_init_(DBNet(), self.seed).state_dict(),
                      **dbnet_from_app_state(sd)}
        except Exception as e:
            logger.error("Failed to load model: %s", e)
            raise
        return {k: v.to(self.device) for k, v in sd.items()}

    def save_model(self, model_path: str) -> str:
        """Write the model's full state dict (its compute dtype, on the
        CPU; a model split over a mesh row is gathered) to ``model_path``,
        any name, in the port's torch format; returns the path."""
        return save_state_dict(model_path, self.model)

    def replica(self, devices, min_size: int = MIN_SIZE) -> "TextDetector":
        """This detector with its own copy of the model (the same weights
        and compute dtype; no checkpoint is read) on ``devices``: one
        device, or a mesh row whose wide layers (``min_size`` as in
        ``tensor_parallel_``) the copy is split over, its activations on
        the row's first entry."""
        row = (list(devices) if isinstance(devices, (list, tuple))
               else [devices])
        new = copy.copy(self)
        new.device = resolve_device(row[0])
        new.model = tensor_parallel_(copy.deepcopy(self.model), row,
                                     min_size)
        return new

    # ------------------------------------------------------------------
    def probability(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 BGR [B,H,W,3] or I420 [B,H*3/2,W] on the device ->
        probability maps [B, S, S] in the compute dtype."""
        if frames_u8.dim() == 3:
            frames_u8 = yuv420_to_bgr(frames_u8)
        # the reference hands the model a bf16 input whatever the model's
        # compute dtype (preprocess_frames' default)
        x = preprocess_frames(frames_u8, self.input_size, torch.bfloat16)
        return self.model.probability(x.permute(0, 3, 1, 2))

    def _ship(self, frames: np.ndarray) -> np.ndarray:
        """BGR [B,H,W,3] -> I420 [B,H*3/2,W] when configured; packed input
        passes through."""
        if self.transfer_format != "yuv420" or frames.ndim == 3:
            return frames
        import cv2

        return np.stack(
            [cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420) for f in frames]
        )

    def _upload(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):  # staged on the device already
            return frames.to(self.device)
        return torch.from_numpy(
            np.ascontiguousarray(self._ship(frames))
        ).to(self.device)

    @torch.inference_mode()
    def detect_batch_arrays(
        self, frames: np.ndarray, confidence_threshold: float = 0.5
    ) -> Dict[str, torch.Tensor]:
        """[B,H,W,3] uint8 (numpy, or a tensor staged on the device) ->
        fixed-size result tensors on the device."""
        prob = self.probability(self._upload(frames))
        return db_postprocess(
            prob, confidence_threshold, max_dets=self.max_dets,
            max_box_frac=self.max_box_frac,
        )

    def _detect_packed(
        self, frames: np.ndarray, confidence_threshold: float
    ) -> np.ndarray:
        """[B, K, 28] uint8: float16 boxes(4) + polygon(8) + score(1) +
        valid(1), the layout the reference ships to the host."""
        post = self.detect_batch_arrays(frames, confidence_threshold)
        b = post["boxes"].shape[0]
        det16 = torch.cat(
            [
                post["boxes"],
                post["polygons"].reshape(b, self.max_dets, 8),
                post["scores"][..., None],
                post["valid"].to(torch.float32)[..., None],
            ],
            -1,
        ).to(torch.float16)
        return det16.view(torch.uint8).cpu().numpy()

    def detect_batch(
        self, frames: np.ndarray, confidence_threshold: float = 0.5
    ) -> List[List[Dict[str, Any]]]:
        """[B,H,W,3] uint8 (or I420 [B,H*3/2,W]) -> per-frame lists of
        detection dicts."""
        if frames.ndim == 3:
            b, h15, w = frames.shape
            h = (h15 * 2) // 3
        else:
            b, h, w = frames.shape[:3]
        pack = self._detect_packed(frames, confidence_threshold)
        det16 = np.ascontiguousarray(pack).view(np.float16).astype(np.float32)
        return [
            extract_detections(
                {
                    "boxes": det16[i, :, 0:4],
                    "polygons": det16[i, :, 4:12].reshape(-1, 4, 2),
                    "scores": det16[i, :, 12],
                    "valid": det16[i, :, 13] > 0.5,
                },
                w, h, self.input_size,
            )
            for i in range(b)
        ]

    def detect(
        self, image: np.ndarray, confidence_threshold: float = 0.5
    ) -> List[Dict[str, Any]]:
        """Single-frame API; [] on failure."""
        try:
            return self.detect_batch(image[None], confidence_threshold)[0]
        except Exception as e:
            logger.error("Detection failed: %s", e)
            return []
