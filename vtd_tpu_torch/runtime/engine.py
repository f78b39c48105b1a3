"""Multi-stream inference engine (port of ``vtd_tpu/runtime/engine.py``).

One engine per card interleaves frames from many streams into the same
batched device program: a scheduler thread collects frames, buckets them
by ``(shape, orig_size)`` so that streams of different resolutions never
share a batch, pads each bucket to the engine batch, dispatches it through
the pipeline's ``dispatch_batch`` and resolves one Future per frame from
``process_batch``. ``submit_batch`` takes a whole pre-stacked batch with
one Future. Up to ``pipeline_depth`` batches stay in flight, so the host
stacks and uploads batch k+1 while the card runs batch k.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.schemas import summarize
from .pipeline import VideoTextPipeline

logger = logging.getLogger(__name__)

_BATCH = "__batch__"  # queue tag of a pre-stacked batch


class InferenceEngine:
    """``pipeline``: a built :class:`VideoTextPipeline`, or none and
    ``**pipeline_kwargs`` to build one (on the card unless they say
    ``device="cpu"``). ``max_wait_ms``: how long a partial bucket waits
    for more frames before it is dispatched padded."""

    def __init__(
        self,
        pipeline: Optional[VideoTextPipeline] = None,
        max_wait_ms: float = 20.0,
        **pipeline_kwargs,
    ):
        self.pipeline = pipeline or VideoTextPipeline(**pipeline_kwargs)
        self.batch_size = self.pipeline.batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.batches_dispatched = 0
        self._q: "queue.Queue[Tuple[Any, Any, Future]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit_frame(
        self, frame: np.ndarray, orig_size: Optional[Tuple[int, int]] = None
    ) -> Future:
        """Enqueue one frame; resolves to its list of detection dicts.

        ``frame`` is a raw BGR frame (resized here to ``host_downscale``
        before dispatch when the pipeline has one) or, with
        ``orig_size``, a frame already in the pipeline's transfer format
        (what ``extract_frame_batches`` gives), whose detections scale
        back to ``orig_size``."""
        fut: Future = Future()
        if self._stop.is_set():
            fut.set_exception(RuntimeError("engine is closed"))
            return fut
        self._q.put(((frame.shape, orig_size), frame, fut))
        return fut

    def submit_batch(
        self,
        frames: np.ndarray,
        valid: np.ndarray,
        orig_size: Optional[Tuple[int, int]] = None,
    ) -> Future:
        """Enqueue one pre-stacked batch of the engine's size; resolves
        to the per-slot list of detection lists (index it with
        ``valid``). No bucketing and one Future for the batch."""
        fut: Future = Future()
        if self._stop.is_set():
            fut.set_exception(RuntimeError("engine is closed"))
            return fut
        self._q.put((_BATCH, (frames, valid, orig_size), fut))
        return fut

    def close(self):
        """Stop the scheduler after it has flushed what it holds; fail any
        Future that raced in after that."""
        self._stop.set()
        self._thread.join(timeout=30)
        while True:
            try:
                _, _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("engine closed"))

    # ------------------------------------------------------------------
    def _loop(self):
        buckets: Dict[Tuple, List[Tuple[np.ndarray, Future]]] = {}
        deadline: Dict[Tuple, float] = {}
        inflight: deque = deque()
        depth = getattr(self.pipeline, "pipeline_depth", 2)

        def push(dispatched):
            if dispatched is not None:
                inflight.append(dispatched)

        while not self._stop.is_set():
            try:
                key, item, fut = self._q.get(timeout=self.max_wait / 2)
                if key == _BATCH:
                    push(self._dispatch_stacked(*item, fut))
                else:
                    buckets.setdefault(key, []).append((item, fut))
                    deadline.setdefault(key, time.monotonic() + self.max_wait)
            except queue.Empty:
                # idle tick: nothing new, finish what is in flight
                while inflight:
                    self._finish_batch(*inflight.popleft())
            now = time.monotonic()
            for key in list(buckets):
                items = buckets[key]
                if len(items) >= self.batch_size or now >= deadline[key]:
                    buckets[key] = items[self.batch_size:]
                    if buckets[key]:
                        deadline[key] = now + self.max_wait
                    else:
                        del buckets[key], deadline[key]
                    push(self._dispatch_items(items[: self.batch_size], key))
            while len(inflight) > depth:
                self._finish_batch(*inflight.popleft())
        # shutdown: dispatch every bucketed frame, then drain
        for key, items in buckets.items():
            for i in range(0, len(items), self.batch_size):
                push(self._dispatch_items(items[i:i + self.batch_size], key))
        while inflight:
            self._finish_batch(*inflight.popleft())

    def _dispatch(self, frames: np.ndarray, valid: np.ndarray):
        handles = self.pipeline.dispatch_batch(frames, valid_frames=valid)
        self.batches_dispatched += 1
        return handles

    def _dispatch_stacked(self, frames, valid, orig_size, fut: Future):
        """Enqueue a pre-stacked batch; the batch resolves through one
        Future."""
        try:
            handles = self._dispatch(frames, valid)
            return fut, frames, valid, orig_size, handles
        except Exception as e:
            logger.exception("engine batch dispatch failed")
            fut.set_exception(e)
            return None

    def _dispatch_items(self, items: List[Tuple[np.ndarray, Future]], key):
        """Stack one bucket's frames (padded with its last frame) and
        enqueue them; returns the state for :meth:`_finish_batch`."""
        try:
            n = len(items)
            _, orig_size = key
            raw = [f for f, _ in items]
            raw += [raw[-1]] * (self.batch_size - n)
            if orig_size is None:  # raw BGR submissions
                orig_size = raw[0].shape[:2]
                ds = self.pipeline.host_downscale
                if ds and orig_size != (ds, ds):
                    import cv2

                    raw = [
                        cv2.resize(f, (ds, ds), interpolation=cv2.INTER_LINEAR)
                        for f in raw
                    ]
            frames = np.stack(raw)
            valid = np.zeros(self.batch_size, bool)
            valid[:n] = True
            handles = self._dispatch(frames, valid)
            return items, frames, valid, orig_size, handles
        except Exception as e:  # resolve every Future, even on failure
            logger.exception("engine dispatch failed")
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(e)
            return None

    def _finish_batch(self, items, frames, valid, orig_size, handles):
        try:
            per_frame = self.pipeline.process_batch(
                frames, valid, handles=handles, orig_size=orig_size
            )
            if isinstance(items, Future):  # submit_batch
                items.set_result(per_frame)
            else:
                for i, (_, fut) in enumerate(items):
                    fut.set_result(per_frame[i])
        except Exception as e:
            logger.exception("engine batch failed")
            futs = [items] if isinstance(items, Future) else [
                fut for _, fut in items
            ]
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)

    # ------------------------------------------------------------------
    def process_videos(
        self, video_paths: List[str], target_fps: float = 10.0
    ) -> Dict[str, Dict[str, Any]]:
        """Process several videos concurrently through this engine: one
        decoder thread a video (the pipeline's ``decode_backend``) submits
        batches in the pipeline's transfer format; results keep each
        video's frame order. Returns {path: the result dict of
        ``process_video``}.
        Raises ``ImportError`` where cv2 is absent and ``ValueError`` for
        a video that does not open (the reference returns an empty
        success for it)."""
        import cv2  # noqa: F401  the decode path; raises where cv2 is absent

        results: Dict[str, Dict[str, Any]] = {}
        errors: List[BaseException] = []
        lock = threading.Lock()

        def worker(path: str):
            try:
                t0 = time.time()
                vp = self.pipeline.video_processor
                info = vp.get_video_info(path)
                if not info:
                    raise ValueError(f"Cannot open video: {path}")
                pending = []
                for batch in vp.extract_frame_batches(
                    path,
                    batch_size=self.batch_size,
                    target_fps=target_fps,
                    resize_to=self.pipeline.ship_dims(info),
                    pixel_format=self.pipeline.transfer_format,
                    decode_backend=self.pipeline.decode_backend,
                ):
                    if batch.get("frames") is None:
                        continue
                    pending.append((
                        batch["frame_numbers"], batch["timestamps"],
                        batch["valid"],
                        self.submit_batch(
                            batch["frames"], batch["valid"],
                            orig_size=batch["orig_size"],
                        ),
                    ))
                frames_out = []
                for nums, ts, bvalid, fut in pending:
                    per_frame = fut.result(timeout=600)
                    for i in np.nonzero(bvalid)[0]:
                        frames_out.append({
                            "frame_number": int(nums[i]),
                            "timestamp": float(ts[i]),
                            "detections": per_frame[i],
                        })
                elapsed = time.time() - t0
                with lock:
                    results[path] = {
                        "status": "success",
                        "results": frames_out,
                        "summary": summarize(
                            frames_out, elapsed, len(frames_out)),
                        "video_info": info,
                    }
            except Exception as e:  # re-raised in the caller
                with lock:
                    errors.append(e)

        threads = [
            threading.Thread(target=worker, args=(p,)) for p in video_paths
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results
