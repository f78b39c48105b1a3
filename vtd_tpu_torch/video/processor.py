"""Host-side video decode: the port's copy of the cv2 decode path of
``vtd_tpu/video/processor.py:VideoProcessor``.

``extract_frame_batches`` yields fixed-size uint8 frame batches (tail
padded by repeating the last frame, ``valid`` marking real slots),
decoded in background threads. Frames can be resized on the host and
shipped I420-packed, and ``sample_mode="keyframe"`` ships only
scene-change frames through the reference's cv2 gate. ``cv2`` is
imported inside the functions that need it. The native libav decoder
(and its in-decoder keyframe gate) waits for a later slice of the port.
"""
from __future__ import annotations

import logging
import queue
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Generator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


@contextmanager
def _capture(video_path: str):
    import cv2

    cap = cv2.VideoCapture(video_path)
    try:
        yield cap
    finally:
        cap.release()


class VideoProcessor:
    """Video metadata probe + fps-throttled, batched frame extraction."""

    def __init__(self):
        self.supported_formats = [".mp4", ".avi", ".mov", ".mkv", ".wmv"]

    def get_video_info(self, video_path: str) -> Dict[str, Any]:
        """Probe fps/frames/size/duration; ``{}`` on failure."""
        try:
            import cv2

            with _capture(video_path) as cap:
                if not cap.isOpened():
                    raise ValueError(f"Cannot open video: {video_path}")
                info: Dict[str, Any] = {
                    "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                    "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                    "fps": cap.get(cv2.CAP_PROP_FPS),
                }
            info["duration"] = (
                info["frame_count"] / info["fps"] if info["fps"] > 0 else 0
            )
            info["format"] = Path(video_path).suffix.lower()
            return info
        except Exception as e:
            logger.error("Failed to get video info: %s", e)
            return {}

    def extract_frames_at_fps(
        self, video_path: str, target_fps: float = 10
    ) -> Generator[Tuple[np.ndarray, int, float], None, None]:
        """Yield (frame, extracted_index, timestamp): every
        ``max(1, int(src_fps / target_fps))``-th decoded frame."""
        yield from self._segment_candidates(video_path, target_fps)

    def _segment_candidates(
        self,
        video_path: str,
        target_fps: float,
        src_range: Optional[Tuple[int, int]] = None,
        strict: bool = False,
    ) -> Generator[Tuple[np.ndarray, int, float], None, None]:
        """(frame, candidate_index, timestamp) for the stride candidates
        whose source frame lies in ``src_range`` ([start, end); the whole
        video when None). candidate_index = source_frame // interval."""
        import cv2

        cap = cv2.VideoCapture(video_path)
        try:
            if not cap.isOpened():
                raise ValueError(f"Cannot open video: {video_path}")
            source_fps = cap.get(cv2.CAP_PROP_FPS)
            interval = (
                max(1, int(source_fps / target_fps)) if source_fps > 0 else 1
            )
            start, end = src_range if src_range else (0, None)
            if start:
                cap.set(cv2.CAP_PROP_POS_FRAMES, start)
                # a seek may land on a keyframe before the target
                pos = int(cap.get(cv2.CAP_PROP_POS_FRAMES))
                if pos != start:
                    if pos > start or pos < 0:
                        cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                        pos = 0
                    while pos < start and cap.grab():
                        pos += 1
            frame_number = start
            while end is None or frame_number < end:
                if not cap.grab():
                    break
                if frame_number % interval == 0:
                    ret, frame = cap.retrieve()
                    if not ret:
                        break
                    ts = frame_number / source_fps if source_fps > 0 else 0.0
                    yield frame, frame_number // interval, ts
                frame_number += 1
        except Exception as e:
            logger.error("Frame extraction failed: %s", e)
            if strict:
                raise
            return
        finally:
            cap.release()

    @staticmethod
    def _keyframe_signature(frame: np.ndarray) -> np.ndarray:
        """Tiny grayscale thumbnail used for scene-change detection."""
        import cv2

        luma = frame if frame.ndim == 2 else cv2.cvtColor(
            frame, cv2.COLOR_BGR2GRAY
        )
        return cv2.resize(
            luma, (64, 36), interpolation=cv2.INTER_AREA
        ).astype(np.int16)

    def extract_frame_batches(
        self,
        video_path: str,
        batch_size: int = 8,
        target_fps: float = 10,
        prefetch: int = 2,
        resize_to: Optional[int | Tuple[int, int]] = None,
        pixel_format: str = "bgr",
        sample_mode: str = "stride",
        keyframe_diff: float = 4.0,
        keyframe_max_gap: Optional[int] = None,
        decode_workers: int = 1,
        decode_backend: str = "auto",
    ) -> Generator[Dict[str, Any], None, None]:
        """Yield {'frames': [B,H,W,3] or I420 [B,H*3/2,W] uint8 or None,
        'frame_numbers', 'timestamps', 'valid', 'orig_size', 'pixel_format',
        'dups'} batches of exactly ``batch_size`` frames.

        ``resize_to``: an int (square) or (w, h) host-side resize;
        ``decode_workers`` > 1 decodes contiguous segments concurrently.
        ``decode_backend`` 'auto' and 'cv2' both decode with cv2 here.

        ``sample_mode``: 'stride' ships every stride candidate; 'keyframe'
        ships only scene-change keyframes: a candidate whose 64x36
        grayscale mean abs diff from the last shipped keyframe is below
        ``keyframe_diff``, and that is fewer than ``keyframe_max_gap``
        candidates after it (default ~2 s worth), goes into the next
        batch's ``dups`` list as ``(frame_number, timestamp,
        ref_frame_number)`` instead. A trailing dup-only batch has
        ``frames=None``.
        """
        if decode_backend not in ("auto", "cv2"):
            raise NotImplementedError(
                "the native libav decoder waits for a later slice of the "
                "port; use decode_backend='cv2' or 'auto'"
            )
        import cv2

        q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        stop = threading.Event()
        max_gap = keyframe_max_gap or max(1, int(2 * target_fps))
        resize_wh: Optional[Tuple[int, int]] = (
            None if resize_to is None
            else (resize_to, resize_to) if isinstance(resize_to, int)
            else (int(resize_to[0]), int(resize_to[1]))
        )

        class _Stopped(Exception):
            pass

        def put(item) -> None:
            # a consumer that abandons the generator sets ``stop``
            while True:
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    if stop.is_set():
                        raise _Stopped()

        def produce_segment(src_range):
            try:
                _produce_segment(src_range)
            except _Stopped:
                pass
            except Exception as e:
                try:
                    put(e)
                except _Stopped:
                    pass

        def _produce_segment(src_range):
            buf_frames: List[np.ndarray] = []
            buf_nums: List[int] = []
            buf_ts: List[float] = []
            buf_dups: List[Tuple[int, float, int]] = []
            orig_size: List[Tuple[int, int]] = []

            def flush():
                n = len(buf_frames)
                if n == 0 and not buf_dups:
                    return
                if n == 0:  # trailing duplicates with no keyframe left
                    put({"frames": None, "dups": list(buf_dups)})
                    buf_dups.clear()
                    return
                pad = batch_size - n
                valid = np.zeros(batch_size, bool)
                valid[:n] = True
                put(
                    {
                        "frames": np.stack(buf_frames + [buf_frames[-1]] * pad),
                        "frame_numbers": np.asarray(
                            buf_nums + [buf_nums[-1]] * pad, np.int64
                        ),
                        "timestamps": np.asarray(
                            buf_ts + [buf_ts[-1]] * pad, np.float64
                        ),
                        "valid": valid,
                        "orig_size": orig_size[0],
                        "pixel_format": pixel_format,
                        "dups": list(buf_dups),
                    }
                )
                buf_frames.clear()
                buf_nums.clear()
                buf_ts.clear()
                buf_dups.clear()

            last_sig: Optional[np.ndarray] = None
            last_kf = -1
            since_kf = 0
            for frame, idx, ts in self._segment_candidates(
                video_path, target_fps, src_range,
                strict=src_range is not None,
            ):
                if stop.is_set():
                    return
                if sample_mode == "keyframe":
                    sig = self._keyframe_signature(frame)
                    if last_sig is not None and since_kf < max_gap:
                        diff = float(np.abs(sig - last_sig).mean())
                        if diff < keyframe_diff:
                            since_kf += 1
                            buf_dups.append((idx, ts, last_kf))
                            continue
                    last_sig, last_kf, since_kf = sig, idx, 0
                if not orig_size:
                    orig_size.append(frame.shape[:2])
                if resize_wh is not None and frame.shape[:2] != (
                    resize_wh[1], resize_wh[0],
                ):
                    frame = cv2.resize(
                        frame, resize_wh, interpolation=cv2.INTER_LINEAR
                    )
                if pixel_format == "yuv420":
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420)
                buf_frames.append(frame)
                buf_nums.append(idx)
                buf_ts.append(ts)
                if len(buf_frames) == batch_size:
                    flush()
            flush()

        def coordinator():
            try:
                workers = max(1, int(decode_workers))
                info = (
                    self.get_video_info(video_path) if workers > 1 else {}
                )
                total = int(info.get("frame_count", 0) or 0)
                if workers == 1 or total <= 0:
                    produce_segment(None)
                    return
                fps = info.get("fps", 0) or 0
                interval = max(1, int(fps / target_fps)) if fps > 0 else 1
                # segment bounds on the candidate stride, so every worker
                # emits exactly the serial pass's candidates
                cands = (total + interval - 1) // interval
                per = max(1, (cands + workers - 1) // workers)
                ranges = [
                    (wi * per * interval, min((wi + 1) * per * interval, total))
                    for wi in range(workers)
                    if wi * per * interval < total
                ]
                threads = [
                    threading.Thread(
                        target=produce_segment, args=(r,), daemon=True
                    )
                    for r in ranges
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            finally:
                try:
                    put(None)
                except _Stopped:
                    pass

        t = threading.Thread(target=coordinator, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
