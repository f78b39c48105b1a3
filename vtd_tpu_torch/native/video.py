"""ctypes binding of the port's native libav video decoder
(``video_decode.cpp``).

The decoder keeps sampled frames in the codec's own yuv420p from decode
through the scale to the ship size, and gates near-duplicate keyframe
candidates inside the decoder; ``video/processor.py`` feeds the pipeline
from it when ``decode_backend`` is 'auto' or 'native'.

The library is built with g++ at first use into ``vtd_tpu_torch/.build/``
(listed in ``.gitignore``), with the reference's flags and link line,
named after a hash of the source, the flags and the libraries. Whether
the host can build it is decided in two parts:

* libav absent: g++ is missing, or one of ``AV_HEADERS`` does not
  resolve through ``g++ -E``. ``available()`` is False, and the first
  call logs at INFO what was missing; callers at 'auto' decode with cv2.
* libav present but the build or the load fails: ``build()`` (and so
  ``available()``) raises ``RuntimeError`` with the compiler's output.
  Nothing falls back to cv2.

A file whose container or codec defeats the reader still falls back:
``open_video`` returns None for it.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "video_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
AV_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]
AV_HEADERS = (
    "libavcodec/avcodec.h", "libavformat/avformat.h",
    "libavutil/imgutils.h", "libswscale/swscale.h",
)

logger = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_missing: Optional[str] = None  # the probe's answer, once taken
_probed = False


def libav_missing() -> Optional[str]:
    """What keeps this host from building the decoder (g++ or libav's
    headers), or None where both are present. Probed once a process;
    the first answer that names something is logged at INFO."""
    global _missing, _probed
    with _lock:
        if _probed:
            return _missing
        gxx = shutil.which("g++")
        if gxx is None:
            _missing = "g++ not found on PATH"
        else:
            absent = [
                h for h in AV_HEADERS
                if subprocess.run(
                    [gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                    input=f"#include <{h}>\n", capture_output=True,
                    text=True, timeout=60,
                ).returncode != 0
            ]
            if absent:
                _missing = ("libav development headers not found by g++ -E: "
                            + ", ".join(absent))
        _probed = True
        if _missing:
            logger.info("native video decoder unavailable: %s; "
                        "decode_backend='auto' decodes with cv2", _missing)
        return _missing


def _target() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS + AV_LIBS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libvtdvideo-{digest}.so"


def build() -> Path:
    """Compile ``video_decode.cpp`` (once per source hash); return the
    library's path. Raises ``RuntimeError`` when libav is absent (naming
    what is missing) or when g++ fails (with its output)."""
    out = _target()
    if out.exists():
        return out
    missing = libav_missing()
    if missing:
        raise RuntimeError(f"native video decoder unavailable: {missing}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(
        [shutil.which("g++"), *GXX_FLAGS, str(SRC), "-o", str(tmp),
         *AV_LIBS],
        capture_output=True, text=True, timeout=300,
    )
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for {SRC.name} (exit {res.returncode}):\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    logger.info("built %s", out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_i64, c_dbl, c_void = (ctypes.c_int, ctypes.c_int64,
                                   ctypes.c_double, ctypes.c_void_p)
    p_u8, p_i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(c_i64)
    lib.vtd_vd_open.restype = c_void
    lib.vtd_vd_open.argtypes = [ctypes.c_char_p]
    lib.vtd_vd_info.restype = c_int
    lib.vtd_vd_info.argtypes = [
        c_void, ctypes.POINTER(c_dbl), p_i64, ctypes.POINTER(c_int),
        ctypes.POINTER(c_int),
    ]
    lib.vtd_vd_seek.restype = c_int
    lib.vtd_vd_seek.argtypes = [c_void, c_i64]
    # h, stride, max_frames, src_end, hot, out, src_indices, out_w, out_h,
    # fmt
    batch_args = [c_void, c_int, c_int, c_i64, c_int, p_u8, p_i64, c_int,
                  c_int, c_int]
    lib.vtd_vd_read_batch.restype = c_int
    lib.vtd_vd_read_batch.argtypes = batch_args
    lib.vtd_vd_read_batch_kf.restype = c_int
    lib.vtd_vd_read_batch_kf.argtypes = batch_args + [
        c_dbl, c_int, c_int,  # kf_diff, kf_max_gap, kf_reset
        p_i64, p_i64, c_int, ctypes.POINTER(c_int),  # dups, max, n_dups
    ]
    lib.vtd_vd_close.restype = None
    lib.vtd_vd_close.argtypes = [c_void]
    return lib


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = build()
        with _lock:
            if _lib is None:
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as e:
                    raise RuntimeError(
                        f"native video decoder {path} does not load: {e}"
                    ) from e
                _lib = _bind(lib)
    return _lib


def available() -> bool:
    """Whether the decoder can be used here: False where libav (or g++)
    is absent; where libav is present, builds and loads the library and
    returns True, or raises ``RuntimeError`` when that fails."""
    if libav_missing():
        return False
    _get_lib()
    return True


class NativeVideoReader:
    """Streaming decoder over one video file.

    ``read_batch(stride, max_frames)`` returns (frames, src_indices):
    frames is uint8 [n, out_h*3/2, out_w] (I420) or [n, out_h, out_w, 3]
    (BGR), n <= max_frames, n == 0 at EOF; every ``stride``-th source
    frame is sampled.
    """

    def __init__(self, path: str, out_size: Tuple[int, int],
                 pixel_format: str = "yuv420"):
        lib = _get_lib()
        self._lib = lib
        self._h = lib.vtd_vd_open(str(path).encode())
        if not self._h:
            raise ValueError(f"cannot open video: {path}")
        self.out_w, self.out_h = out_size
        self.fmt = 1 if pixel_format == "bgr" else 0
        self.pixel_format = pixel_format
        if self.fmt == 0:
            # I420 plane math (chroma stride w/2, V at w*h*5/4, h*3/2
            # rows) needs even dims: an odd one would make sws_scale write
            # past the buffer. Callers read back out_w / out_h.
            self.out_w &= ~1
            self.out_h &= ~1
        self._hot = 0  # a seek leaves the target frame decoded, pending
        self._kf_reset = 0  # a seek starts a new scene-change segment
        fps = ctypes.c_double()
        nframes = ctypes.c_int64()
        w = ctypes.c_int()
        h = ctypes.c_int()
        lib.vtd_vd_info(self._h, ctypes.byref(fps), ctypes.byref(nframes),
                        ctypes.byref(w), ctypes.byref(h))
        self.fps = fps.value
        self.frame_count = int(nframes.value)
        self.src_w, self.src_h = int(w.value), int(h.value)

    def seek(self, src_index: int) -> None:
        """Position so the next emitted frame is ``src_index`` (exact)."""
        ret = self._lib.vtd_vd_seek(self._h, int(src_index))
        if ret < 0:
            raise ValueError(f"seek to frame {src_index} failed ({ret})")
        self._hot = 1
        self._kf_reset = 1

    def _buffers(self, max_frames: int):
        shape = ((max_frames, self.out_h, self.out_w, 3) if self.fmt == 1
                 else (max_frames, self.out_h * 3 // 2, self.out_w))
        return np.empty(shape, np.uint8), np.empty(max_frames, np.int64)

    def _batch_args(self, stride, max_frames, src_end, out, idx):
        return (
            self._h, int(stride), int(max_frames), int(src_end), self._hot,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.out_w, self.out_h, self.fmt,
        )

    def read_batch(self, stride: int, max_frames: int,
                   src_end: int = -1) -> Tuple[np.ndarray, np.ndarray]:
        out, idx = self._buffers(max_frames)
        n = self._lib.vtd_vd_read_batch(
            *self._batch_args(stride, max_frames, src_end, out, idx))
        self._hot = 0
        if n < 0:
            raise RuntimeError(f"native decode error ({n})")
        return out[:n], idx[:n]

    def read_batch_kf(
        self, stride: int, max_frames: int, src_end: int = -1,
        kf_diff: float = 4.0, kf_max_gap: int = 20, max_dups: int = 4096,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Keyframe-gated read: (frames, src_indices, dup_indices,
        dup_refs). A candidate whose 64x36 luma thumbnail differs from
        the last kept frame's by a mean abs diff below ``kf_diff`` (and
        that is fewer than ``kf_max_gap`` candidates after it) never
        crosses into Python as pixels: only its (source index, covering
        keyframe's source index) pair does. EOF when all four arrays are
        empty."""
        out, idx = self._buffers(max_frames)
        dup_idx = np.empty(max_dups, np.int64)
        dup_ref = np.empty(max_dups, np.int64)
        n_dups = ctypes.c_int(0)
        n = self._lib.vtd_vd_read_batch_kf(
            *self._batch_args(stride, max_frames, src_end, out, idx),
            float(kf_diff), int(kf_max_gap), self._kf_reset,
            dup_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dup_ref.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            int(max_dups), ctypes.byref(n_dups),
        )
        self._hot = 0
        self._kf_reset = 0
        if n < 0:
            raise RuntimeError(f"native decode error ({n})")
        k = int(n_dups.value)
        return out[:n], idx[:n], dup_idx[:k], dup_ref[:k]

    def close(self) -> None:
        if self._h:
            self._lib.vtd_vd_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_video(path: str, out_size: Tuple[int, int],
               pixel_format: str = "yuv420") -> Optional[NativeVideoReader]:
    """A reader, or None where libav is absent or the file's container or
    codec defeats the decoder (callers at 'auto' decode it with cv2).
    Raises ``RuntimeError`` where libav is present but the decoder does
    not build or load."""
    if not available():
        return None
    try:
        return NativeVideoReader(path, out_size, pixel_format)
    except ValueError as e:
        logger.info("native decode unavailable for %s: %s", path, e)
        return None
