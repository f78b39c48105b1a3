"""CTC greedy decoding (port of ``vtd_tpu/ops/ctc.py``).

Device side: per-timestep argmax ids, max probabilities, the emit mask
(drop blanks, repeats and <unk>) and the mean confidence over emitted
steps, for a whole batch. Host side: strings from (ids, emit).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.crnn import BLANK_ID, ID_TO_CHAR, UNK_ID


def ctc_greedy_decode_arrays(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """logits [B, T, V] -> {'ids': [B,T] int32, 'emit': [B,T] bool,
    'probs': [B,T] f32, 'confidence': [B] f32}. ``torch.argmax`` takes the
    first maximum, as ``jnp.argmax`` does."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    ids = torch.argmax(probs, dim=-1).to(torch.int32)
    pmax = probs.amax(-1)
    prev = torch.nn.functional.pad(ids[:, :-1], (1, 0), value=-1)
    emit = (ids != BLANK_ID) & (ids != prev) & (ids != UNK_ID)
    n = emit.sum(1)
    conf = (pmax * emit).sum(1) / torch.clamp(n, min=1)
    conf = torch.where(n > 0, conf, 0.0)
    return {"ids": ids, "emit": emit, "probs": pmax, "confidence": conf}


def emit_mask_np(ids: np.ndarray) -> np.ndarray:
    """Host-side CTC collapse rule on an [..., T] id array (the same rule
    as above, for ids that arrive without their emit mask)."""
    prev = np.concatenate(
        [np.full(ids.shape[:-1] + (1,), -1, ids.dtype), ids[..., :-1]],
        axis=-1,
    )
    return (ids != BLANK_ID) & (ids != prev) & (ids != UNK_ID)


def ids_to_text(ids: np.ndarray, emit: np.ndarray) -> List[str]:
    """Host: [B, T] id/emit arrays -> decoded strings."""
    out: List[str] = []
    for b in range(ids.shape[0]):
        chars = [
            ID_TO_CHAR.get(int(i), "")
            for i in ids[b][emit[b].astype(bool)]
        ]
        out.append("".join(c for c in chars if len(c) == 1))
    return out


def decode_batch(logits: torch.Tensor) -> List[Tuple[str, float]]:
    """Convenience: logits [B, T, V] -> [(text, confidence)]."""
    arrs = ctc_greedy_decode_arrays(logits)
    texts = ids_to_text(arrs["ids"].cpu().numpy(), arrs["emit"].cpu().numpy())
    confs = arrs["confidence"].cpu().numpy()
    return [(t, float(c)) for t, c in zip(texts, confs)]
