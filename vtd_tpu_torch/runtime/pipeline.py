"""VideoTextPipeline (port of ``vtd_tpu/runtime/pipeline.py``).

Same API and result dicts as the reference: ``process_video`` (async,
progress callback, summary), ``process_single_frame``, and the batch API
``dispatch_batch`` / ``process_batch``. Per frame batch the device runs
one program: I420 unpack -> preprocess -> DBNet probability branch -> DB
postprocess -> crop every slot, and then
  * CRNN engine: CRNN on the top ``rec_budget`` slots -> greedy CTC, all
    shipped to the host in one small uint8 pack;
  * transformer engine (``use_transformer_ocr=True``): the crops, cut to
    the TrOCR input size and normalised, stay on the device; the host
    reads the detection pack, keeps the slots that pass its filters, and
    the recogniser decodes them in chunks of ``rec_chunk``.
PyTorch launches asynchronously, so ``dispatch_batch`` returns once the
work is enqueued (apart from the labelling's convergence checks, which
wait for the device) and the pack lands in pinned host memory behind an
event.

``sample_mode="keyframe"`` ships only the scene-change frames that the
cv2 gate of ``video/processor.py`` keeps and gives each near-duplicate
candidate its keyframe's detections. Every batch feeds the
``model_inference_duration_seconds`` / ``model_batch_size`` histograms
and every transformer chunk ``recognizer_chunk_occupancy``
(``obs/metrics.py``).

``profile_dir`` wraps what the reference wraps in ``jax.profiler.trace``
(the dispatcher thread and the collect loop of ``process_video``) in a
``torch.profiler`` trace of every thread's CPU ops and, on the card, its
kernels, written as a Chrome trace to
``<profile_dir>/process_video-<pid>-<unix ms>.json``.

Not in this slice: multi-device meshes and the two-stage runner (each
raises NotImplementedError).
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.schemas import summarize
from ..obs import metrics as _metrics
from ..ops.crop import crop_and_resize_boxes_mm
from ..ops.ctc import ctc_greedy_decode_arrays, emit_mask_np, ids_to_text
from ..ops.db_postprocess import db_postprocess
from ..video.processor import VideoProcessor
from .detector import TextDetector
from .recognizer import TextRecognizer

logger = logging.getLogger(__name__)

# Largest detector input whose rotated-box corners (up to size*sqrt(2))
# stay under 1024, where float16 rounds to 0.25 px; above it the det
# block of the pack is float32.
_F16_SAFE_INPUT = 724

# torch.profiler runs one trace at a time in a process.
_trace_lock = threading.Lock()


@contextlib.contextmanager
def _profile_span(profile_dir: Optional[str], device: torch.device):
    """A ``torch.profiler`` trace of the span, exported as a Chrome trace
    to ``<profile_dir>/process_video-<pid>-<unix ms>.json``; nothing
    without ``profile_dir``. The trace holds every thread's CPU ops and,
    on the card, the kernels. A call that finds another call's trace
    running writes none: its work is in that trace already."""
    if not profile_dir or not _trace_lock.acquire(blocking=False):
        yield
        return
    try:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(
            profile_dir,
            f"process_video-{os.getpid()}-{int(time.time() * 1e3)}.json",
        )
        # the kernels are launched from the dispatcher thread
        with profile(activities=activities,
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            yield
        prof.export_chrome_trace(path)
    finally:
        _trace_lock.release()


def _dedup_summary(all_results: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Temporal-dedup summary fields: cross-frame text tracks (the same
    string at an overlapping position in nearby frames is one track),
    without singleton fragments: a 1-character string seen in a single
    frame is far more likely postprocess noise than scene text."""
    from ..ops.nms import temporal_dedup as merge_tracks

    tracks = merge_tracks(all_results)
    confirmed = [
        t for t in tracks if t["count"] >= 2 or len(t["text"]) >= 2
    ]
    texts = sorted({t["text"] for t in confirmed})
    return {
        "text_tracks": confirmed,
        "detected_texts": texts,
        "unique_texts": len(texts),
    }


class VideoTextPipeline:
    def __init__(
        self,
        detector_path: Optional[str] = None,
        recognizer_path: Optional[str] = None,
        use_transformer_ocr: bool = True,
        confidence_threshold: float = 0.5,
        min_recognition_confidence: float = 0.0,
        batch_size: int = 16,
        max_dets: int = 64,
        max_box_frac: float = 0.95,
        target_fps: float = 10.0,
        rec_chunk: Optional[int] = None,
        rec_budget: Optional[int] = None,
        detector_input_size: int = 640,
        host_downscale: Optional[int] = None,
        transfer_format: str = "bgr",
        recognizer_kwargs: Optional[Dict[str, Any]] = None,
        temporal_dedup: bool = False,
        profile_dir: Optional[str] = None,
        sample_mode: str = "stride",
        decode_workers: int = 1,
        pipeline_depth: int = 3,
        decode_backend: str = "auto",
        preserve_aspect: bool = True,
        mesh: Optional[Any] = None,
        parallel_mode: str = "fused",
        device: str = "cuda",
    ):
        if mesh is not None or parallel_mode != "fused":
            raise NotImplementedError(
                "mesh and parallel_mode='two_stage' wait for the port's "
                "multi-GPU slice"
            )
        self.device = resolve_device(device)
        self.detector = TextDetector(
            detector_path, input_size=detector_input_size,
            max_dets=max_dets, device=device,
        )
        self.recognizer = TextRecognizer(
            recognizer_path, use_transformer=use_transformer_ocr,
            device=device, **(recognizer_kwargs or {})
        )
        self.video_processor = VideoProcessor()
        # None = max(2*max_dets, B*K/4) crop slots recognized per batch
        self.rec_budget = rec_budget
        self._rec_budget_warned = False
        self.confidence_threshold = confidence_threshold
        self.min_recognition_confidence = min_recognition_confidence
        self.batch_size = batch_size
        self.max_dets = max_dets
        self.max_box_frac = max_box_frac  # 1.0 disables the filter
        self.target_fps = target_fps
        self.host_downscale = host_downscale
        self.transfer_format = transfer_format
        self.preserve_aspect = preserve_aspect
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.decode_workers = decode_workers
        self.decode_backend = decode_backend
        # Cross-frame text-track merging in the summary
        self.temporal_dedup = temporal_dedup
        # Opt-in torch.profiler trace around the hot loop
        self.profile_dir = profile_dir
        # 'keyframe' ships only scene-change keyframes to the device and
        # propagates each keyframe's detections to the near-duplicate
        # candidates it covers (video/processor.extract_frame_batches).
        self.sample_mode = sample_mode
        self.use_transformer = use_transformer_ocr
        if use_transformer_ocr:
            tr = self.recognizer.transformer
            self.crop_hw = (tr.cfg.image_size, tr.cfg.width)
            # Crops decoded per recogniser call. It bounds memory, not a
            # compile bucket: one encoder layer's float32 scores take
            # chunk x heads x N^2 x 4 B (1024 crops of 384x384 through a
            # ViT-base at once would need ~16 GB). The last chunk of a
            # batch is simply shorter.
            self.rec_chunk = int(rec_chunk or tr.pad_batch)
            if self.rec_chunk < 1:
                raise ValueError(f"rec_chunk must be >= 1, got {rec_chunk}")
        else:
            self.crop_hw = (32, 128)
            self.rec_chunk = None  # the CRNN reads its whole budget at once
        self._pack_np = (
            np.float32
            if detector_input_size > _F16_SAFE_INPUT
            else np.float16
        )
        # Overflow recovery: once one batch has more valid detections
        # than the budget, every later batch recognizes every slot.
        self._full_budget_latched = False

    # ------------------------------------------------------------------
    def _effective_rec_budget(self, b: int) -> int:
        """Recognized crop slots per b-frame batch (the device program and
        the host-side overflow check share this)."""
        bk = b * self.max_dets
        return min(bk, self.rec_budget or max(2 * self.max_dets, bk // 4))

    def _run_batch(
        self,
        frames_u8: torch.Tensor,
        thresh: float,
        frame_valid: torch.Tensor,
        full_budget: bool,
    ):
        """The per-batch device program -> (uint8 pack [B, K, nbytes],
        crops or None). CRNN engine: det block (boxes 4, polygon 8,
        score, valid, CTC confidence) as float16 (float32 above
        ``_F16_SAFE_INPUT``) bytes, then T ids; no crops. Transformer
        engine: the 14-column det block alone, and the normalised crops
        [B*K, H, W, 3] that stay on the device."""
        k = self.max_dets
        size = self.detector.input_size
        out_h, out_w = self.crop_hw
        if frames_u8.dim() == 3:  # I420-packed [B, H*3/2, W]
            from ..ops.preprocess import yuv420_to_bgr

            frames_u8 = yuv420_to_bgr(frames_u8)
        b, h, w = frames_u8.shape[:3]
        prob = self.detector.probability(frames_u8)
        post = db_postprocess(
            prob, thresh, max_dets=k, max_box_frac=self.max_box_frac
        )
        # padding frames (batch tails) must not produce valid slots
        valid = post["valid"] & frame_valid[:, None]
        scale = torch.tensor(
            [w / size, h / size, w / size, h / size],
            dtype=torch.float32, device=prob.device,
        )
        crops = crop_and_resize_boxes_mm(
            frames_u8, post["boxes"] * scale, valid, out_h=out_h, out_w=out_w
        ).reshape(b * k, out_h, out_w, 3)

        pack_dt = torch.float16 if self._pack_np == np.float16 else torch.float32
        det_cols = [
            post["boxes"],
            post["polygons"].reshape(b, k, 8),
            post["scores"][..., None],
            valid.to(torch.float32)[..., None],
        ]
        if self.use_transformer:
            det = torch.cat(det_cols, -1).to(pack_dt)
            # BGR [0,1] -> RGB, mean/std 0.5 (the TrOCR processor's
            # normalisation), held in the encoder's input type
            crops = ((crops.flip(-1) - 0.5) / 0.5).to(
                self.recognizer.transformer.cfg.dtype
            )
            return det.view(torch.uint8).reshape(b, k, -1), crops

        bk = b * k
        budget = bk if full_budget else self._effective_rec_budget(b)
        if budget < bk:
            # recognize the top-``budget`` slots by (valid, score), lower
            # slot first on ties as jax.lax.top_k, and scatter back
            key = valid.reshape(bk).to(torch.float32) * 2.0 + post[
                "scores"
            ].reshape(bk)
            sel = torch.sort(key, descending=True, stable=True).indices[
                :budget
            ]
            ctc_r = ctc_greedy_decode_arrays(
                self.recognizer.logits(crops[sel])
            )
            conf = torch.zeros(bk, dtype=torch.float32, device=prob.device)
            conf[sel] = ctc_r["confidence"]
            ids = torch.zeros(
                (bk, ctc_r["ids"].shape[-1]), dtype=torch.int32,
                device=prob.device,
            )
            ids[sel] = ctc_r["ids"]
        else:
            ctc_r = ctc_greedy_decode_arrays(self.recognizer.logits(crops))
            conf, ids = ctc_r["confidence"], ctc_r["ids"]
        det = torch.cat(det_cols + [conf.reshape(b, k, 1)], -1).to(pack_dt)
        det_bytes = det.view(torch.uint8).reshape(b, k, -1)
        ids_u8 = ids.reshape(b, k, -1).to(torch.uint8)
        return torch.cat([det_bytes, ids_u8], -1), None

    # ------------------------------------------------------------------
    def ship_dims(self, video_info: Dict[str, Any]):
        """Transfer dims for one video: ``host_downscale`` square, or with
        ``preserve_aspect`` the source aspect at max-dim
        ``host_downscale``, never upscaled, in multiples of 8. None ships
        the source resolution."""
        ds = self.host_downscale
        if not ds:
            return None
        if not self.preserve_aspect:
            return ds
        w0 = int(video_info.get("width", 0) or 0)
        h0 = int(video_info.get("height", 0) or 0)
        if w0 <= 0 or h0 <= 0:
            return ds
        s = min(1.0, ds / max(w0, h0))
        ship_w = max(8, int(round(w0 * s / 8)) * 8)
        ship_h = max(8, int(round(h0 * s / 8)) * 8)
        return (ship_w, ship_h)

    # ------------------------------------------------------------------
    def _dispatch_batch(
        self,
        frames: np.ndarray,
        confidence_threshold: Optional[float] = None,
        valid_frames: Optional[np.ndarray] = None,
        full_budget: bool = False,
    ) -> Dict[str, Any]:
        """Enqueue the device program for one batch; the result pack is
        copied into pinned host memory behind an event."""
        thr = (
            self.confidence_threshold
            if confidence_threshold is None
            else confidence_threshold
        )
        valid = (
            np.ones(len(frames), bool) if valid_frames is None
            else np.asarray(valid_frames, bool)
        )
        on_cuda = self.device.type == "cuda"
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if on_cuda:
            host = host.pin_memory()
        with torch.inference_mode():
            frames_dev = host.to(self.device, non_blocking=on_cuda)
            valid_dev = torch.from_numpy(valid).to(self.device)
            pack, crops = self._run_batch(
                frames_dev, thr, valid_dev,
                full_budget or self._full_budget_latched,
            )
            if not on_cuda:
                return {"pack": pack, "event": None, "crops": crops}
            out = torch.empty(
                pack.shape, dtype=torch.uint8, pin_memory=True
            )
            out.copy_(pack, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return {"pack": out, "event": event, "crops": crops}

    @staticmethod
    def _collect(handles: Dict[str, Any]) -> np.ndarray:
        if handles["event"] is not None:
            handles["event"].synchronize()
        return handles["pack"].numpy()

    def _parse_pack(self, out_pack: np.ndarray, b: int) -> Dict[str, Any]:
        """Decode the pack: det block of 14 columns, plus on the CRNN
        engine the CTC confidence column and the uint8 CTC ids."""
        nf = 14 if self.use_transformer else 15
        itemsize = np.dtype(self._pack_np).itemsize
        det = np.ascontiguousarray(
            out_pack[..., : itemsize * nf]
        ).view(self._pack_np).astype(np.float32)
        ctc = None
        if not self.use_transformer:
            ids = out_pack[..., itemsize * nf:].reshape(
                b * self.max_dets, -1
            ).astype(np.int32)
            ctc = {
                "ids": ids,
                "emit": emit_mask_np(ids),
                "confidence": det[..., 14].reshape(-1),
            }
        return {
            "boxes": det[..., 0:4],
            "polys": det[..., 4:12].reshape(b, self.max_dets, 4, 2),
            "scores": det[..., 12],
            "valid": det[..., 13] > 0.5,
            "ctc": ctc,
        }

    def _recognize_slots(
        self, crops_flat: torch.Tensor, need: List[int]
    ) -> Dict[int, Any]:
        """Transformer engine: decode the kept slots in chunks of
        ``rec_chunk``. Every chunk is enqueued before the first result is
        read, so the host waits for the device once per batch."""
        tr = self.recognizer.transformer
        outs = []
        for c0 in range(0, len(need), self.rec_chunk):
            chunk = need[c0:c0 + self.rec_chunk]
            sel = torch.as_tensor(
                chunk, dtype=torch.int64, device=crops_flat.device,
            )
            outs.append(tr.generate(crops_flat[sel]))
            _metrics.recognizer_chunk_occupancy.observe(
                len(chunk) / self.rec_chunk
            )
        if not outs:
            return {}
        toks = torch.cat([t for t, _ in outs]).cpu().numpy()
        confs = torch.cat([c for _, c in outs]).cpu().numpy()
        return {
            flat: (tr.tokenizer.decode(toks[i]), float(confs[i]))
            for i, flat in enumerate(need)
        }

    def _process_batch(
        self, frames: np.ndarray, valid_frames: np.ndarray, handles=None,
        orig_size=None, confidence_threshold: Optional[float] = None,
        min_recognition_confidence: Optional[float] = None,
    ) -> List[List[Dict[str, Any]]]:
        """One frame batch -> per-frame lists of recognized-region dicts.
        ``orig_size``: true (h, w) of the source when ``frames`` were
        downscaled on the host."""
        if frames.ndim == 3:  # I420-packed
            b, h15, w = frames.shape
            h = (h15 * 2) // 3
        else:
            b, h, w = frames.shape[:3]
        if orig_size is not None:
            h, w = orig_size
        size = self.detector.input_size
        t0 = time.perf_counter()
        if handles is None:
            handles = self._dispatch_batch(
                frames, valid_frames=valid_frames,
                confidence_threshold=confidence_threshold,
            )
        parsed = self._parse_pack(self._collect(handles), b)

        # Slots past the recognition budget carry blank transcripts: a
        # batch that overflows is dispatched again with the full budget
        # (its pack is authoritative for everything), and the pipeline
        # latches to the full budget for every later batch.
        n_valid = int(np.count_nonzero(parsed["valid"]))
        budget = self._effective_rec_budget(b)
        if (
            parsed["ctc"] is not None
            and n_valid > budget
            and not self._full_budget_latched
        ):
            if not self._rec_budget_warned:
                self._rec_budget_warned = True
                logger.warning(
                    "batch has %d valid detections but the recognition "
                    "budget is %d: recovering via a full-budget second "
                    "pass and latching to the full budget. Raise "
                    "rec_budget (up to batch_size*max_dets) to avoid it.",
                    n_valid, budget,
                )
            self._full_budget_latched = True
            full = self._dispatch_batch(
                frames, confidence_threshold=confidence_threshold,
                valid_frames=valid_frames, full_budget=True,
            )
            parsed = self._parse_pack(self._collect(full), b)

        boxes = parsed["boxes"]
        polys = parsed["polys"]
        scores = parsed["scores"]
        valid = parsed["valid"]
        ctc = parsed["ctc"]
        sx, sy = w / size, h / size
        bx = (boxes * np.asarray([sx, sy, sx, sy])).astype(np.int64)
        size_ok = (bx[..., 2] - bx[..., 0] > 10) & (
            bx[..., 3] - bx[..., 1] > 10
        )
        keep = valid & size_ok & np.asarray(valid_frames)[:, None]
        need_ij = np.argwhere(keep)
        need: List[int] = (
            need_ij[:, 0] * self.max_dets + need_ij[:, 1]
        ).tolist()
        polys_int = np.round(polys).astype(int)
        texts: Dict[int, Any] = {}
        if ctc is None:
            texts = self._recognize_slots(handles["crops"], need)
        elif need:
            sel = np.asarray(need)
            decoded = ids_to_text(ctc["ids"][sel], ctc["emit"][sel])
            for kk, flat in enumerate(need):
                texts[flat] = (decoded[kk], float(ctc["confidence"][flat]))
        # from the collect of this batch to its last transcript (the
        # reference's span, vtd_tpu/runtime/pipeline.py:616-723)
        _metrics.metrics_collector.record_model_inference(
            time.perf_counter() - t0,
            "transformer" if self.use_transformer else "DBNet-CRNN",
            b,
        )
        min_rconf = (
            self.min_recognition_confidence
            if min_recognition_confidence is None
            else min_recognition_confidence
        )
        results: List[List[Dict[str, Any]]] = [[] for _ in range(b)]
        for (i, j), flat in zip(need_ij, need):
            text, rconf = texts[flat]
            if rconf < min_rconf:
                continue
            results[int(i)].append(
                {
                    "bbox": bx[i, j].tolist(),
                    "text": text,
                    "detection_confidence": float(scores[i, j]),
                    "recognition_confidence": rconf,
                    "polygon": polys_int[i, j].tolist(),
                }
            )
        return results

    # ------------------------------------------------------------------
    def dispatch_batch(
        self,
        frames: np.ndarray,
        confidence_threshold: Optional[float] = None,
        valid_frames: Optional[np.ndarray] = None,
    ):
        """Enqueue the device program for one fixed-size frame batch and
        return opaque handles for :meth:`process_batch`. Dispatch batch
        k+1 before collecting batch k to overlap host and device work.
        ``valid_frames``: [B] bool marking real (non-padding) frames."""
        return self._dispatch_batch(
            frames, confidence_threshold=confidence_threshold,
            valid_frames=valid_frames,
        )

    def process_batch(
        self,
        frames: np.ndarray,
        valid_frames: np.ndarray,
        handles=None,
        orig_size=None,
        confidence_threshold: Optional[float] = None,
        min_recognition_confidence: Optional[float] = None,
    ) -> List[List[Dict[str, Any]]]:
        """One frame batch (or its handles from :meth:`dispatch_batch`) ->
        per-frame lists of recognized-region dicts."""
        return self._process_batch(
            frames, valid_frames, handles=handles, orig_size=orig_size,
            confidence_threshold=confidence_threshold,
            min_recognition_confidence=min_recognition_confidence,
        )

    # ------------------------------------------------------------------
    async def process_video(
        self,
        video_path: str,
        output_dir: str = "",
        progress_callback: Optional[Callable] = None,
        resume_file: Optional[str] = None,
        confidence_threshold: Optional[float] = None,
        min_recognition_confidence: Optional[float] = None,
        temporal_dedup: Optional[bool] = None,
        sample_mode: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Process a whole video; the result dict of the reference.

        ``pipeline_depth`` batches stay in flight: a dispatcher thread
        decodes, uploads and enqueues while this coroutine collects.
        ``resume_file`` appends each finished frame as a JSON line and
        skips frames already there on a restart.
        """
        import asyncio as _asyncio
        import json as _json
        import os as _os
        import queue as _queue
        import threading as _threading

        dedup = self.temporal_dedup if temporal_dedup is None else temporal_dedup
        mode = self.sample_mode if sample_mode is None else sample_mode
        thr = (
            self.confidence_threshold
            if confidence_threshold is None
            else confidence_threshold
        )
        ckpt_fh = None
        try:
            start_time = time.time()
            video_info = self.video_processor.get_video_info(video_path)
            if not video_info:
                raise ValueError(f"Cannot open video: {video_path}")

            done_frames: Dict[int, Dict[str, Any]] = {}
            if resume_file:
                if _os.path.exists(resume_file):
                    with open(resume_file) as fh:
                        for line in fh:
                            try:
                                rec = _json.loads(line)
                                done_frames[rec["frame_number"]] = rec
                            except ValueError:
                                continue  # torn write from a crash
                ckpt_fh = open(resume_file, "a")

            src_fps = video_info.get("fps", 0) or 0
            total_src = video_info.get("frame_count", 0)
            interval = (
                max(1, int(src_fps / self.target_fps)) if src_fps > 0 else 1
            )
            total_expected = (
                (total_src + interval - 1) // interval if total_src else 0
            )
            all_results: List[Dict[str, Any]] = []
            frame_count = 0

            batches = self.video_processor.extract_frame_batches(
                video_path,
                batch_size=self.batch_size,
                target_fps=self.target_fps,
                resize_to=self.ship_dims(video_info),
                pixel_format=self.transfer_format,
                sample_mode=mode,
                decode_workers=self.decode_workers,
                decode_backend=self.decode_backend,
            )
            # frame_number -> detections of keyframes, for propagation to
            # the near-duplicate candidates each keyframe covers
            kf_detections: Dict[int, List[Dict[str, Any]]] = {}

            async def collect(batch, handles):
                nonlocal frame_count
                per_frame = (
                    self._process_batch(
                        batch["frames"], batch["valid"], handles=handles,
                        orig_size=batch.get("orig_size"),
                        confidence_threshold=thr,
                        min_recognition_confidence=min_recognition_confidence,
                    )
                    if handles is not None
                    else None
                )
                nvalid = (
                    int(batch["valid"].sum())
                    if batch.get("frames") is not None
                    else 0
                )
                for i in range(nvalid):
                    fn = int(batch["frame_numbers"][i])
                    if per_frame is None:
                        rec = done_frames[fn]  # restored from checkpoint
                    else:
                        rec = {
                            "frame_number": fn,
                            "timestamp": float(batch["timestamps"][i]),
                            "detections": per_frame[i],
                        }
                        if ckpt_fh is not None:
                            ckpt_fh.write(_json.dumps(rec) + "\n")
                    kf_detections[fn] = rec["detections"]
                    all_results.append(rec)
                # Keyframe mode: each near-duplicate candidate inherits
                # its keyframe's detections (the gate found the
                # downsampled frames alike), so results cover every
                # stride candidate without device work for the dups.
                for fn, ts, ref in batch.get("dups") or []:
                    if fn in done_frames:
                        rec = done_frames[fn]
                    else:
                        rec = {
                            "frame_number": int(fn),
                            "timestamp": float(ts),
                            "detections": [
                                dict(d) for d in kf_detections.get(ref, [])
                            ],
                            "duplicate_of": int(ref),
                        }
                        if ckpt_fh is not None:
                            ckpt_fh.write(_json.dumps(rec) + "\n")
                    all_results.append(rec)
                    frame_count += 1
                if ckpt_fh is not None and per_frame is not None:
                    ckpt_fh.flush()
                frame_count += nvalid
                if progress_callback:
                    progress = (
                        frame_count / total_expected if total_expected else 0
                    )
                    await progress_callback(
                        progress, frame_count, total_expected
                    )

            dispatch_q: _queue.Queue = _queue.Queue(
                maxsize=self.pipeline_depth
            )
            stop_evt = _threading.Event()

            def dispatcher():
                try:
                    for batch in batches:
                        already_done = batch.get("frames") is None or all(
                            int(fn) in done_frames
                            for fn, v in zip(
                                batch["frame_numbers"], batch["valid"]
                            )
                            if v
                        )
                        handles = (
                            None if already_done
                            else self._dispatch_batch(
                                batch["frames"], confidence_threshold=thr,
                                valid_frames=batch["valid"],
                            )
                        )
                        while not stop_evt.is_set():
                            try:
                                dispatch_q.put((batch, handles), timeout=0.1)
                                break
                            except _queue.Full:
                                continue
                        if stop_evt.is_set():
                            return
                    dispatch_q.put(None)
                except BaseException as e:  # raised on the collect side
                    dispatch_q.put(e)

            with _profile_span(self.profile_dir, self.device):
                disp_t = _threading.Thread(target=dispatcher, daemon=True)
                disp_t.start()
                loop = _asyncio.get_running_loop()
                try:
                    while True:
                        item = await loop.run_in_executor(
                            None, dispatch_q.get
                        )
                        if item is None:
                            break
                        if isinstance(item, BaseException):
                            raise item
                        await collect(*item)
                finally:
                    stop_evt.set()
                    while not dispatch_q.empty():
                        try:
                            dispatch_q.get_nowait()
                        except _queue.Empty:
                            break
                    disp_t.join(timeout=10.0)
            # dups follow their keyframe's batch, and parallel segment
            # decode interleaves batches: restore frame order
            all_results.sort(key=lambda r: r["frame_number"])
            processing_time = time.time() - start_time
            summary = summarize(all_results, processing_time, frame_count)
            if dedup:
                summary.update(_dedup_summary(all_results))
            return {
                "status": "success",
                "results": all_results,
                "summary": summary,
                "video_info": video_info,
            }
        except InterruptedError:
            raise  # cooperative cancellation from the progress callback
        except Exception as e:
            logger.error("Video processing failed: %s", e)
            return {"status": "failed", "error": str(e), "results": []}
        finally:
            if ckpt_fh is not None:
                ckpt_fh.close()

    # ------------------------------------------------------------------
    def process_single_frame(
        self,
        frame: np.ndarray,
        confidence_threshold: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Single-frame API: detections without polygons."""
        try:
            per_frame = self._process_batch(
                frame[None], np.asarray([True]),
                confidence_threshold=confidence_threshold,
            )
            dets = [
                {k: v for k, v in d.items() if k != "polygon"}
                for d in per_frame[0]
            ]
            return {"detections": dets}
        except Exception as e:
            logger.error("Single frame processing failed: %s", e)
            return {"detections": [], "error": str(e)}
