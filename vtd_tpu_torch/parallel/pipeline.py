"""Two-stage pipeline parallelism (port of ``vtd_tpu/parallel/pipeline.py``):
detect on one group of devices, recognise on the other.

Stage A (decode, preprocess, DBNet, DB postprocess, crop, the det block)
runs on ``devices[:split]`` with the batch split in contiguous blocks
over the group; stage B (CRNN + greedy CTC and the pack on the CRNN
path; the crops kept for the TrOCR decode on the transformer path) runs
on ``devices[split:]`` with the batch split again over that group. Every
device has its own copy of its stage's model and a :class:`Replica`
(one thread, one CUDA stream): stage A of batch k+1 runs while stage B
works on batch k. The det block and the crops hop to the device of
stage B that takes their rows (a cross-device copy on the card, ordered
after stage A's work by an event).

``VideoTextPipeline(parallel_mode="two_stage")`` swaps the runner in
through :meth:`TwoStagePipeline.dispatch`, whose handles have the fused
program's layout (the CRNN pack, or the det block and the crops), so
everything downstream works unchanged. Stage B recognises every slot:
the runner takes no recognition budget.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.mesh import visible_devices
from ..runtime.pipeline import (
    _F16_SAFE_INPUT,
    collect,
    detect_and_crop,
    recognize_pack,
    ship_pack,
    trocr_input,
    upload,
)
from .sharding import Replica, batch_sharding, row_blocks, shard_variables


class TwoStagePipeline:
    """Detector stage on ``devices[:split]`` (default half), recognizer
    stage on the rest. ``devices`` default to every visible CUDA device,
    or two entries of the CPU for ``device="cpu"``; entries may repeat
    (both stages on one card)."""

    def __init__(
        self,
        detector,
        recognizer,
        use_transformer: bool = False,
        devices: Optional[Sequence[Any]] = None,
        split: Optional[int] = None,
        max_dets: int = 64,
        crop_hw: Tuple[int, int] = (32, 128),
        max_box_frac: float = 0.95,
        device: str = "cuda",
    ):
        if devices is None:
            devices = visible_devices(device)
            if devices[0].type == "cpu":
                devices = devices * 2
        devices = [resolve_device(d) for d in devices]
        if len(devices) < 2:
            raise ValueError("pipeline parallelism needs >= 2 devices")
        split = split if split is not None else len(devices) // 2
        if not 0 < split < len(devices):
            raise ValueError(f"split {split} leaves a stage without devices")
        self.group_sizes = (split, len(devices) - split)
        self.detector = detector
        self.recognizer = recognizer
        self.use_transformer = use_transformer
        self.max_dets = max_dets
        self.crop_hw = crop_hw
        self.max_box_frac = max_box_frac
        self.stage_a = [
            Replica(d, detector=m) for d, m in zip(
                devices[:split], shard_variables(detector, devices[:split]))
        ]
        self.stage_b = [
            Replica(d, recognizer=m) for d, m in zip(
                devices[split:], shard_variables(recognizer, devices[split:]))
        ]
        # the fused program's pack precision
        self.pack_dt = (torch.float32 if detector.input_size > _F16_SAFE_INPUT
                        else torch.float16)

    # ------------------------------------------------------------------
    def _stage_a(self, rep: Replica, frames: np.ndarray, thresh: float):
        dev = rep.device
        det, crops = detect_and_crop(
            rep.detector, upload(frames, dev), thresh,
            torch.ones(len(frames), dtype=torch.bool, device=dev),
            self.max_dets, self.max_box_frac, self.crop_hw,
        )
        if self.use_transformer:
            crops = trocr_input(crops, self.recognizer.transformer.cfg.dtype)
        event = None
        if rep.stream is not None:
            event = torch.cuda.Event()
            event.record(rep.stream)
        return {"det": det, "crops": crops, "event": event, "rep": rep}

    @staticmethod
    def _hop(t: torch.Tensor, src: Dict[str, Any], rep: Replica):
        """``t`` (stage A's, on ``src``'s device) onto stage B replica
        ``rep``'s device, ordered after stage A's work."""
        if rep.stream is None:
            return t.to(rep.device)
        rep.stream.wait_event(src["event"])
        # a cross-device copy runs on the source device's current stream
        with torch.cuda.stream(src["rep"].stream):
            out = t.to(rep.device, non_blocking=True)
        out.record_stream(rep.stream)
        return out

    def _stage_b(self, rep: Replica, a_parts, b: int, j: int):
        k = self.max_dets
        dets, crops = [], []
        for i, lo, hi in row_blocks(b, len(a_parts), len(self.stage_b), j):
            src = a_parts[i].result()
            dets.append(self._hop(src["det"][lo:hi], src, rep))
            crops.append(self._hop(src["crops"][lo * k:hi * k], src, rep))
        det, crops = torch.cat(dets), torch.cat(crops)
        if self.use_transformer:
            det_bytes = det.to(self.pack_dt).view(torch.uint8).reshape(
                len(det), k, -1)
            return ship_pack(det_bytes, crops)
        pack = recognize_pack(rep.recognizer, det, crops, det.shape[0] * k,
                              self.pack_dt)
        return ship_pack(pack)

    def dispatch(self, frames: np.ndarray, thresh: float) -> Dict[str, Any]:
        """Enqueue both stages for one batch -> the pipeline's handles:
        ``shards`` (a Future per stage-B block, in order) and the stage-B
        ``replicas`` holding each block's crops."""
        b = len(frames)
        batch_sharding(frames, self.group_sizes[1])  # raises unless even
        a_parts = [rep.submit(self._stage_a, block, thresh) for rep, block in
                   zip(self.stage_a,
                       batch_sharding(frames, self.group_sizes[0]))]
        return {
            "shards": [rep.submit(self._stage_b, a_parts, b, j)
                       for j, rep in enumerate(self.stage_b)],
            "replicas": list(self.stage_b),
        }

    @staticmethod
    def wire(handles: Dict[str, Any]):
        """Wait for a dispatched batch -> the fused program's wire layout:
        ``(out_pack,)`` on the CRNN path, ``(det_bytes, crops_b)`` on the
        transformer path (host uint8 arrays [B, K, nbytes]; ``crops_b`` the
        stage-B blocks' normalised crops, on their devices)."""
        pack, parts = collect(handles)
        if parts[0]["crops"] is not None:
            return pack, [part["crops"] for part in parts]
        return (pack,)

    def __call__(self, frames_u8: np.ndarray, thresh: float):
        """One batch through both stages -> its wire layout (see
        :meth:`wire`). The replicas hold their own weights, so, unlike the
        reference's call, no variables are passed."""
        return self.wire(self.dispatch(frames_u8, thresh))

    def run_batches(self, batches: List[np.ndarray], thresh: float = 0.5):
        """Every batch dispatched before the first is collected (stage A
        of a batch overlaps stage B of the one before) -> per-batch wire
        layouts."""
        handles = [self.dispatch(frames, thresh) for frames in batches]
        return [self.wire(h) for h in handles]

    def stage_devices(self) -> Tuple[List[str], List[str]]:
        return ([str(r.device) for r in self.stage_a],
                [str(r.device) for r in self.stage_b])

    def close(self) -> None:
        for rep in self.stage_a + self.stage_b:
            rep.close()
