"""Host C++ of the port, bound with ctypes (port of ``vtd_tpu/native``).

``ctc_beam_decode``: CTC prefix beam search over recogniser log-probs
(``ctc_beam.cpp``). The library is built with ``g++ -O3 -shared -fPIC
-pthread`` at first use into ``vtd_tpu_torch/.build/`` (listed in
``.gitignore``), named after a hash of the source and the flags, as
``_build.py`` does for the CUDA kernels. There is no fallback: a missing
``g++`` or a failed build raises; ``native_available`` says whether the
library builds and loads. ``ctc_beam_decode_plain`` is the plain Python
version of the same search, which the tests hold the C++ against.

``video``: the native libav video decoder (``video_decode.cpp``) and its
in-decoder keyframe gate, built with g++ into the same directory. Where
libav's headers are absent its ``available()`` is False and callers at
``decode_backend="auto"`` decode with cv2; where libav is present a
failed build raises (see ``video.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from . import video  # noqa: F401  re-exported

SRC = Path(__file__).resolve().parent / "ctc_beam.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

logger = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libctc_beam-{digest}.so"


def build(force: bool = False) -> Path:
    """Compile ``ctc_beam.cpp`` (once per source hash); return the
    library's path. ``force`` compiles again into the same target even
    when it exists; a library this process has loaded stays loaded.
    Raises when g++ is missing or fails."""
    out = _target()
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the port's CTC beam decoder is built "
            "from vtd_tpu_torch/native/ctc_beam.cpp at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(
        [gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
        capture_output=True, text=True, timeout=300,
    )
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for ctc_beam.cpp (exit {res.returncode}):\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ctc_beam_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # log_probs
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, T, V
                ctypes.c_int, ctypes.c_int,  # beam_width, blank
                ctypes.POINTER(ctypes.c_int32),  # out_ids
                ctypes.POINTER(ctypes.c_int32),  # out_lens
                ctypes.POINTER(ctypes.c_float),  # out_scores
                ctypes.c_int, ctypes.c_int,  # max_len, n_threads
            ]
            lib.ctc_beam_decode_batch.restype = None
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the C++ beam library builds and loads here; never raises
    (False when g++ is missing or the build or the load fails)."""
    try:
        _get_lib()
    except Exception as e:  # a probe: any failure means "not available"
        logger.warning("native CTC beam unavailable: %s", e)
        return False
    return True


def ctc_beam_decode(
    log_probs: np.ndarray,
    beam_width: int = 8,
    blank: int = 0,
    max_len: int = 64,
    n_threads: int = 0,
) -> Tuple[List[List[int]], np.ndarray]:
    """[B, T, V] log-probs -> (id sequences, scores [B] float32), on the
    C++ decoder. ``n_threads`` <= 0 takes min(cpu count, 8)."""
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    b, t, v = lp.shape
    lib = _get_lib()
    out_ids = np.zeros((b, max_len), np.int32)
    out_lens = np.zeros((b,), np.int32)
    out_scores = np.zeros((b,), np.float32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    lib.ctc_beam_decode_batch(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, t, v, beam_width, blank,
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_len, n_threads,
    )
    seqs = [out_ids[i, : out_lens[i]].tolist() for i in range(b)]
    return seqs, out_scores


# --------------------------------------------------------------------------
# plain Python version (the oracle of the tests and of chip_smoke.py)
# --------------------------------------------------------------------------
def _log_add(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    hi, lo = (a, b) if a > b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))


def _plain_one(lp: np.ndarray, beam_width: int, blank: int):
    beams = {(): (0.0, -math.inf)}  # prefix -> (p_blank, p_non_blank)
    v = lp.shape[1]
    prune = min(v, max(beam_width * 2, 8))
    for row in lp:
        top = np.argpartition(-row, prune - 1)[:prune]
        next_beams: dict = {}

        def upsert(prefix, add_b, add_nb):
            pb, pnb = next_beams.get(prefix, (-math.inf, -math.inf))
            next_beams[prefix] = (_log_add(pb, add_b), _log_add(pnb, add_nb))

        for prefix, (p_b, p_nb) in beams.items():
            total = _log_add(p_b, p_nb)
            last = prefix[-1] if prefix else -1
            upsert(prefix, total + row[blank], -math.inf)
            for s in top:
                s = int(s)
                if s == blank:
                    continue
                p = float(row[s])
                if s == last:
                    upsert(prefix, -math.inf, p_nb + p)
                    upsert(prefix + (s,), -math.inf, p_b + p)
                else:
                    upsert(prefix + (s,), -math.inf, total + p)
        beams = dict(
            sorted(next_beams.items(), key=lambda kv: -_log_add(*kv[1]))[
                :beam_width]
        )
    best, (p_b, p_nb) = max(beams.items(), key=lambda kv: _log_add(*kv[1]))
    return list(best), _log_add(p_b, p_nb)


def ctc_beam_decode_plain(
    log_probs: np.ndarray,
    beam_width: int = 8,
    blank: int = 0,
    max_len: int = 64,
) -> Tuple[List[List[int]], np.ndarray]:
    """The same prefix beam search in Python (float64 arithmetic)."""
    lp = np.asarray(log_probs, dtype=np.float32)
    seqs, scores = [], []
    for i in range(lp.shape[0]):
        ids, score = _plain_one(lp[i], beam_width, blank)
        seqs.append(ids[:max_len])
        scores.append(score)
    return seqs, np.asarray(scores, np.float32)
