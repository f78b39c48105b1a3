"""The benchmark's wrappers around the calls into each layer of the port.

Installed on one built pipeline (instance attributes, and two module
globals of ``vtd_tpu_torch.runtime.pipeline``), they do two things:

* spans (traced runs only): each call runs under a
  ``torch.profiler.record_function`` range named ``pb.<layer>``, and its
  host seconds (``host``) and its start, end and items (``calls``) are
  kept per layer while the window is open:
  ``decode`` (one ``next()`` of ``extract_frame_batches``), ``dispatch``
  (``_dispatch_batch``), ``dbnet`` (``TextDetector.probability``),
  ``postprocess`` (``db_postprocess``), ``crnn`` (``TextRecognizer.logits``),
  ``trocr`` (``TransformerRecognizer.generate``; crops counted);
* samples (every run): a reservoir of batches drawn from the seed among
  those dispatched while the window is open, and for each, what the
  program produced at each layer (``reference/judge.py`` lists it),
  cloned on the device as it is made. The reservoir holds
  ``pipeline_depth`` more than are judged: the batches still in flight
  when the window closes are never answered, and the judge takes the
  first ``k`` of those that were.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

class Taps:
    def __init__(self, pipe, seed: int, k: int, trace: bool):
        self.pipe = pipe
        self.trace = trace
        self.k = k
        self.draw = k + getattr(pipe, "pipeline_depth", 0) if k > 0 else 0
        self.rng = random.Random(seed * 2654435761 % (1 << 61))
        self.open = False  # the window
        self.host: Dict[str, List[float]] = defaultdict(list)
        self.calls: Dict[str, List[tuple]] = defaultdict(list)
        self.counts: Dict[str, int] = defaultdict(int)
        self.reservoir: List[Dict[str, Any]] = []
        self.offered = 0
        self._origin: Dict[int, tuple] = {}
        self._by_handles: Dict[int, Dict[str, Any]] = {}
        self._tl = threading.local()
        self._restore: List = []

    # -- helpers ------------------------------------------------------------
    def _span(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function("pb." + name)

    def _timed(self, name: str, items: int, fn, *a, **kw):
        t = time.perf_counter()
        with self._span(name):
            out = fn(*a, **kw)
        if self.trace and self.open:
            t1 = time.perf_counter()
            self.host[name].append(t1 - t)
            self.calls[name].append((t, t1, items))
        return out

    def _sample(self) -> Optional[Dict[str, Any]]:
        return getattr(self._tl, "sample", None)

    def _offer(self) -> Optional[Dict[str, Any]]:
        """Reservoir sampling over the window's batches."""
        if not self.open or self.draw <= 0:
            return None
        self.offered += 1
        new: Dict[str, Any] = {}
        if len(self.reservoir) < self.draw:
            self.reservoir.append(new)
            return new
        j = self.rng.randrange(self.offered)
        if j < self.draw:
            self.reservoir[j] = new
            return new
        return None

    def _patch(self, obj, name, wrapper):
        self._restore.append((obj, name, obj.__dict__.get(name, _MISSING)))
        setattr(obj, name, wrapper)

    # -- install ------------------------------------------------------------
    def install(self) -> "Taps":
        import vtd_tpu_torch.runtime.pipeline as pl

        pipe = self.pipe
        vp = pipe.video_processor
        orig_extract = vp.extract_frame_batches

        def extract(video_path, *a, **kw):
            gen = orig_extract(video_path, *a, **kw)
            try:
                while True:
                    try:
                        batch = self._timed("decode", 1, next, gen)
                    except StopIteration:
                        return
                    if batch.get("frames") is not None:
                        self._origin[id(batch["frames"])] = (
                            video_path, batch["frame_numbers"].copy(),
                            batch["valid"].copy(), tuple(batch["orig_size"]))
                    yield batch
            finally:
                gen.close()

        self._patch(vp, "extract_frame_batches", extract)

        orig_dispatch = pipe._dispatch_batch

        def dispatch(frames, *a, **kw):
            origin = self._origin.pop(id(frames), None)
            proc = getattr(self._tl, "proc", None)
            if kw.get("full_budget"):  # the overflow's second pass
                held, self._tl.sample = self._sample(), None
                try:
                    handles = self._timed("dispatch", len(frames), orig_dispatch, frames, *a, **kw)
                finally:
                    self._tl.sample = held
                if proc is not None:
                    proc["redo"] = handles
                return handles
            if self.open:
                self.counts["batches"] += 1
                self.counts["valid_frames"] += int(np.asarray(
                    kw.get("valid_frames", np.ones(len(frames), bool))).sum())
            s = self._offer()
            self._tl.sample = s
            try:
                handles = self._timed("dispatch", len(frames), orig_dispatch, frames, *a, **kw)
            finally:
                self._tl.sample = None
            if s is not None:
                s["origin"] = origin
                s["frames"] = np.array(frames, copy=True)
                s["handles"] = handles
                self._by_handles[id(handles)] = s
            return handles

        self._patch(pipe, "_dispatch_batch", dispatch)

        orig_process = pipe._process_batch

        def process(frames, valid_frames, handles=None, *a, **kw):
            s = self._by_handles.pop(id(handles), None)
            self._tl.proc = s
            self._tl.sample = s
            try:
                res = orig_process(frames, valid_frames, handles, *a, **kw)
            finally:
                self._tl.proc = None
                self._tl.sample = None
            if s is not None:
                s["results"] = res
            return res

        self._patch(pipe, "_process_batch", process)

        det = pipe.detector
        orig_prob = det.probability

        def probability(frames_u8):
            out = self._timed("dbnet", frames_u8.shape[0], orig_prob, frames_u8)
            s = self._sample()
            if s is not None:
                s["bgr"] = frames_u8.clone()
                s["prob"] = out.clone()
            return out

        self._patch(det, "probability", probability)

        orig_post = pl.db_postprocess

        def post(prob, *a, **kw):
            out = self._timed("postprocess", prob.shape[0], orig_post, prob, *a, **kw)
            s = self._sample()
            if s is not None:
                s["post"] = {k: out[k].clone() for k in ("boxes", "scores", "valid")}
            return out

        self._restore.append((pl, "db_postprocess", orig_post))
        pl.db_postprocess = post

        orig_dac = pl.detect_and_crop

        def detect_and_crop(*a, **kw):
            det_block, crops = orig_dac(*a, **kw)
            s = self._sample()
            if s is not None:
                s["det"] = det_block.clone()
            return det_block, crops

        self._restore.append((pl, "detect_and_crop", orig_dac))
        pl.detect_and_crop = detect_and_crop

        rec = pipe.recognizer
        if rec.transformer is None:
            orig_logits = rec.logits

            def logits(crops):
                out = self._timed("crnn", crops.shape[0], orig_logits, crops)
                s = self._sample()
                if s is not None:
                    s["crnn_crops"] = crops.clone()
                    s["crnn_logits"] = out.clone()
                return out

            self._patch(rec, "logits", logits)
        else:
            tr = rec.transformer
            orig_gen = tr.generate

            def generate(crops):
                out = self._timed("trocr", crops.shape[0], orig_gen, crops)
                if self.open:
                    self.counts["trocr_crops"] += int(crops.shape[0])
                    self.counts["trocr_chunks"] += 1
                s = self._sample()
                if s is not None:
                    s.setdefault("_chunks", []).append(
                        (crops.clone(), out[0].clone(), out[1].clone()))
                return out

            self._patch(tr, "generate", generate)
            orig_chunks = pipe._decode_chunks

            def decode_chunks(replica, crops_flat, need):
                s = self._sample()
                if s is not None:
                    s["need"] = list(need)
                return orig_chunks(replica, crops_flat, need)

            self._patch(pipe, "_decode_chunks", decode_chunks)
        return self

    def uninstall(self) -> None:
        for obj, name, old in reversed(self._restore):
            if old is _MISSING:
                delattr(obj, name)
            else:
                setattr(obj, name, old)
        self._restore.clear()

    # -- after the window -----------------------------------------------------
    def finished_samples(self, size: int, target_fps: float) -> List[Dict]:
        """The first ``k`` of the reservoir's batches that were answered,
        their device captures on the host side where the judge reads
        numpy, each with its pack read back."""
        out = []
        for s in self.reservoir:
            if "det" not in s or s.get("origin") is None or "results" not in s:
                continue
            if len(out) == self.k:
                break
            h = s["handles"]["shards"][0]
            h = h.result() if hasattr(h, "result") else h
            if h["event"] is not None:
                h["event"].synchronize()
            s["pack"] = h["pack"].numpy().copy()
            redo = s.pop("redo", None)
            if redo is not None:
                r = redo["shards"][0]
                if r["event"] is not None:
                    r["event"].synchronize()
                s["redo_pack"] = r["pack"].numpy().copy()
            s.pop("handles", None)
            s["bgr"] = s["bgr"].cpu().numpy()
            s["det"] = s["det"].float().cpu().numpy()
            s["post"] = {k: v.float().cpu().numpy() if k != "valid" else v.cpu().numpy()
                         for k, v in s["post"].items()}
            chunks = s.pop("_chunks", None)
            if chunks:
                s["trocr_crops"] = torch.cat([c[0] for c in chunks])
                s["trocr_tokens"] = torch.cat([c[1] for c in chunks])
                s["trocr_confs"] = torch.cat([c[2] for c in chunks])
            s["size"] = size
            s["target_fps"] = target_fps
            s["pack_dtype"] = self.pipe._pack_np
            out.append(s)
        return out


_MISSING = object()
