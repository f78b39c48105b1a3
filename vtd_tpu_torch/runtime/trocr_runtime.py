"""Transformer recognizer runtime (port of
``vtd_tpu/runtime/trocr_runtime.py``).

BGR crops in, ``{'text', 'confidence'}`` out; a batch of crops runs one
KV-cached greedy decode. Weights: ``model_path`` names what the
reference's loader takes (an orbax checkpoint directory, a directory or
file holding a pickled ``variables.pkl``; converted with
``convert.trocr_from_jax``) or a torch-format ``.pth`` / ``.pt`` state
dict, in the port's layout or in the HF VisionEncoderDecoder layout; its
architecture comes from a sidecar ``<ckpt>_config.json`` (or
``<ckpt>/config.json``) when no config is passed. Without a path the
weights are drawn from ``seed``.

Unlike the reference there is no zero padding to ``pad_batch``
multiples: rows are independent and PyTorch has no compile bucket to
fill. ``pad_batch`` stays as the pipeline's default chunk size.

Every chunk runs one greedy step (``models/trocr.py:greedy_step_``)
``max_len`` times. On the card, a chunk of 1 to ``pad_batch`` crops
replays it as a CUDA graph (:class:`GraphedDecode`, captured at the
recognizer's first ``generate``), so the host no longer launches every
kernel of every step; the CPU, a model split over a mesh row and larger
chunks call it eagerly (``greedy_generate``).
``trocr_decode_chunks_total{path}`` counts which path each chunk took.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast

from ..core.device import resolve_device
from ..models.trocr import (
    CharTokenizer,
    DecodeState,
    TrOCR,
    TrOCRConfig,
    greedy_generate,
    greedy_step_,
    init_weights_,
    load_config,
)
from ..obs import metrics as _metrics
from ..obs import trace
from ..ops import decode_attention as attention
from ..parallel.tensor_parallel import MIN_SIZE, n_split, tensor_parallel_
from ..train.checkpoint import load_weights

logger = logging.getLogger(__name__)


class GraphedDecode:
    """The greedy decode of an unsplit model on the card, one CUDA graph
    replay a step.

    Static buffers sized ``pad_batch`` rows (a :class:`DecodeState` and
    the cross-attention K/V a chunk's are copied into), and one graph of
    ``greedy_step_`` per row count 1..``pad_batch``, each captured on the
    ``[:b]`` views of those buffers; the graphs share one memory pool (no
    tensor allocated in a capture outlives it). All are captured when the
    object is made. The caller serialises ``decode`` (the buffers are
    one).

    ``launches[b - 1]`` is the number of ``decode_attention`` kernels one
    step of b rows runs (2 per decoder layer): a capture records them
    without running them, so ``decode_attention.launches`` is given them
    back at each replay instead."""

    def __init__(self, model: TrOCR, pad_batch: int, bos_id: int,
                 eos_id: int):
        self.model = model
        self.bos_id, self.eos_id = bos_id, eos_id
        self.device = next(model.parameters()).device
        c = model.cfg
        hd = c.dec_dim // c.dec_heads
        cross = (pad_batch, c.num_patches, c.dec_heads, hd)
        self.enc_kvs = [
            tuple(torch.zeros(cross, dtype=c.dtype, device=self.device)
                  for _ in range(2))
            for _ in range(c.dec_layers)
        ]
        self.state = DecodeState(c, pad_batch, self.device)
        self.views = [self.state.rows(b) for b in range(1, pad_batch + 1)]
        # orders a chunk after the last one where callers' streams differ
        self._last = torch.cuda.Event()
        self.launches: List[int] = []
        self.graphs = self._capture()

    def _capture(self):
        with trace.span("vtd.trocr_capture", len(self.views)), \
                torch.cuda.device(self.device):
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            graphs, pool = [], None
            with torch.cuda.stream(side):
                # eager steps first: cuBLAS handles and workspaces, lazily
                # loaded kernels, every shape once outside a capture
                for b, view in enumerate(self.views, 1):
                    view.start([(k[:b], v[:b]) for k, v in self.enc_kvs],
                               self.bos_id)
                    greedy_step_(self.model, view, self.eos_id)
                for view in self.views:
                    g = torch.cuda.CUDAGraph()
                    before = attention.launches_in_thread()
                    # other threads keep launching eager work meanwhile
                    g.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                    try:
                        greedy_step_(self.model, view, self.eos_id)
                    finally:
                        g.capture_end()
                    n = attention.launches_in_thread() - before
                    attention.count_launches(-n)  # recorded, not run
                    self.launches.append(n)
                    pool = g.pool()
                    graphs.append(g)
            cur.wait_stream(side)
            _metrics.trocr_graph_captures_total.inc(len(graphs))
            return graphs

    def decode(self, enc_kvs):
        """Per-layer cross-attention K/V of b <= ``pad_batch`` rows ->
        (tokens [b, max_len] int32, confidences [b]): new tensors, so
        chunks enqueued back to back each keep their own."""
        b = enc_kvs[0][0].shape[0]
        view, graph = self.views[b - 1], self.graphs[b - 1]
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self._last)
        for (k, v), (ek, ev) in zip(view.enc_kvs, enc_kvs):  # what b reads
            k.copy_(ek)
            v.copy_(ev)
        view.start(view.enc_kvs, self.bos_id)
        for _ in range(self.model.cfg.max_len):
            # an op-scoped record, as an aten op has, so that a profiler
            # links the graph's kernels to this call and to the ranges
            # around it (it links none under a ``record_function`` alone)
            with trace.span("vtd.trocr_step", b), \
                    _RecordFunctionFast("vtd.trocr_graph_replay"):
                graph.replay()
        attention.count_launches(self.launches[b - 1] * self.model.cfg.max_len)
        out = view.toks.clone(), view.confidences()
        self._last.record(cur)
        return out


def _build_kernels() -> None:
    """Compile the card's kernels (``nvcc``, at a checkout's first use)
    while the recognizer makes its weights on the CPU. A failure is logged
    here and raised again by the first launch that needs the kernel."""
    from .._build import build_all

    try:
        build_all()
    except RuntimeError:
        logger.exception("building the CUDA kernels ahead of use failed")


class TransformerRecognizer:
    def __init__(
        self,
        model_path: Optional[str] = None,
        config: Optional[TrOCRConfig] = None,
        tokenizer=None,
        pad_batch: int = 16,
        seed: int = 0,
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or CharTokenizer()
        if config is None and model_path:
            config = self._sidecar_config(model_path)
        if config is None:
            config = TrOCRConfig(vocab_size=self.tokenizer.vocab_size)
            if self.device.type == "cpu":  # bf16 is the card's working type
                config = dataclasses.replace(config, dtype=torch.float32)
        self.cfg = config
        self.pad_batch = pad_batch
        if self.device.type == "cuda":  # the decode step's kernel among them
            threading.Thread(target=_build_kernels, name="vtd-nvcc",
                             daemon=True).start()
        model = TrOCR(self.cfg)
        if model_path:
            model.load_state_dict(self._load(model_path))
        else:
            init_weights_(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self._lock = threading.Lock()
        self._graphed = None  # GraphedDecode, False where none applies

    def replica(self, devices,
                min_size: int = MIN_SIZE) -> "TransformerRecognizer":
        """This recognizer with its own copy of the model (no checkpoint
        is read) on ``devices``: one device, or a mesh row whose wide
        layers (``min_size`` as in ``tensor_parallel_``) the copy is split
        over, its activations on the row's first entry."""
        row = (list(devices) if isinstance(devices, (list, tuple))
               else [devices])
        new = copy.copy(self)
        new.device = resolve_device(row[0])
        new.model = tensor_parallel_(copy.deepcopy(self.model), row,
                                     min_size)
        new._lock = threading.Lock()
        new._graphed = None  # its own graphs, captured in its own thread
        return new

    @staticmethod
    def _sidecar_config(model_path: str) -> Optional[TrOCRConfig]:
        """The architecture a checkpoint carries beside it:
        ``<name>_config.json`` next to ``<name>.pt`` or next to a
        checkpoint directory ``<name>``, ``<name>.pt_config.json``, or
        ``config.json`` inside the directory."""
        p = Path(model_path)
        for cand in (
            p.parent / f"{p.stem}_config.json",
            p.parent / f"{p.name}_config.json",
            p / "config.json",
        ):
            if cand.exists():
                return load_config(str(cand))
        return None

    def _load(self, model_path: str) -> Dict[str, torch.Tensor]:
        from ..convert import trocr_from_hf_state, trocr_from_jax

        sd = load_weights(model_path, trocr_from_jax, self.cfg)
        if any(k.startswith("decoder.model.decoder.") for k in sd):
            sd = trocr_from_hf_state(
                {k: v.float().numpy() for k, v in sd.items()}, self.cfg
            )
        return sd

    # ------------------------------------------------------------------
    def _prepare(self, images: List[np.ndarray]) -> np.ndarray:
        """BGR uint8 crops -> normalised [N, H, W, 3] float32 RGB (mean/std
        0.5, the TrOCR processor's normalisation)."""
        import cv2

        h, w = self.cfg.image_size, self.cfg.width
        out = np.zeros((len(images), h, w, 3), np.float32)
        for i, img in enumerate(images):
            if img.ndim == 2:
                img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
            rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            out[i] = cv2.resize(rgb, (w, h)).astype(np.float32) / 255.0
        return (out - 0.5) / 0.5

    def recognize(self, image: np.ndarray) -> Dict[str, Any]:
        return self.recognize_batch([image])[0]

    def recognize_batch(self, images: List[np.ndarray]) -> List[Dict[str, Any]]:
        if not images:
            return []
        try:
            batch = torch.from_numpy(self._prepare(images)).to(self.device)
            texts, confs = self.recognize_crops_device(batch)
            return [
                {"text": t, "confidence": float(c)} for t, c in zip(texts, confs)
            ]
        except Exception as e:
            logger.error("Text recognition failed: %s", e)
            return [{"text": "", "confidence": 0.0}] * len(images)

    def _graphed_decode(self) -> Optional[GraphedDecode]:
        """This recognizer's graphed decoder, captured at its first call;
        None for a model split over a mesh row, which keeps the eager loop.
        Called under ``_lock``, on the card."""
        if self._graphed is None:
            self._graphed = (
                GraphedDecode(self.model, self.pad_batch,
                              self.tokenizer.BOS, self.tokenizer.EOS)
                if n_split(self.model) == 0 else False)
        return self._graphed or None

    def generate(self, crops: torch.Tensor):
        """Normalised [N, H, W, 3] crops on the device -> (tokens
        [N, max_len] int32, confidences [N]) on the device."""
        with trace.span("vtd.trocr", len(crops)):
            if self.device.type == "cuda" and 1 <= len(crops) <= self.pad_batch:
                with self._lock, torch.inference_mode():
                    graphed = self._graphed_decode()
                    if graphed is not None:
                        _metrics.trocr_decode_chunks_total.labels(
                            path="graph").inc()
                        return graphed.decode(self.model.encode_kv(crops))
            _metrics.trocr_decode_chunks_total.labels(path="eager").inc()
            return greedy_generate(
                self.model, crops,
                bos_id=self.tokenizer.BOS, eos_id=self.tokenizer.EOS,
            )

    def recognize_crops_device(
        self, crops: torch.Tensor
    ) -> Tuple[List[str], np.ndarray]:
        """Normalised [N, H, W, 3] crops -> (texts, confidences [N])."""
        if crops.shape[0] == 0:
            return [], np.zeros(0, np.float32)
        toks, confs = self.generate(crops)
        toks = toks.cpu().numpy()
        return [self.tokenizer.decode(row) for row in toks], confs.cpu().numpy()
