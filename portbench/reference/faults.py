"""Faults planted in what the timed path produced, for the limits' upper
readings at the cell's own size.

Each takes the window's samples and returns copies with one of the
program's outputs altered where it is produced, consistently downstream
where the judge would otherwise catch it by another number:

  box_shift   every valid box of the postprocess grown by ``px`` map
              pixels on each side, its score taken again over the grown
              box (a caliper or unclip fault); read by ``post_iou_gap``
  token       one emitted token a sample changed to another character:
              a CTC step's id of a live recognised slot (CRNN) or a
              decode step before the first <eos> (TrOCR); read by
              ``logit_gap_max``
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

from . import ops
from .judge import _pack_rows, _selected
from .postprocess import box_score

READS = {"box_shift": "post_iou_gap", "token": "logit_gap_max"}


def box_shift(samples: List[Dict], px: float) -> List[Dict]:
    out = []
    for s in samples:
        post = {k: v.copy() for k, v in s["post"].items()}
        prob = s["prob"].float().cpu().numpy()
        h, w = prob.shape[1:]
        for i, j in zip(*np.nonzero(post["valid"])):
            b = post["boxes"][i, j].astype(np.float64) + np.array([-px, -px, px, px])
            b = np.clip(b, 0, [w, h, w, h])
            post["boxes"][i, j] = b
            post["scores"][i, j] = box_score(prob[i], b)
        out.append(dict(s, post=post))
    return out


def token(samples: List[Dict], seed: int, engine: str, max_dets: int) -> List[Dict]:
    rng = random.Random(seed)
    out = []
    for s in samples:
        if engine == "crnn":
            det = s["det"]
            sel = _selected(det, len(s["crnn_crops"]))
            live = [int(f) for f in sel if det.reshape(-1, 14)[f, 13] > 0.5]
            if not live:
                out.append(s)
                continue
            flat = rng.choice(live)
            item = np.dtype(s["pack_dtype"]).itemsize
            _, ids = _pack_rows(s["pack"], "crnn", s["pack_dtype"])
            step = rng.randrange(ids.shape[-1])
            pack = s["pack"].copy()
            b, slot = divmod(flat, max_dets)
            pack[b, slot, item * 15 + step] = (int(ids[b, slot, step]) % 96) + 1
            out.append(dict(s, pack=pack))
        else:
            toks = s.get("trocr_tokens")
            if toks is None or not len(toks):
                out.append(s)
                continue
            toks = toks.clone()
            row = rng.randrange(len(toks))
            is_eos = (toks[row] == ops.TROCR_EOS).nonzero()
            first = int(is_eos[0]) if len(is_eos) else toks.shape[1]
            pos = rng.randrange(max(first, 1))
            t = int(toks[row, pos])
            toks[row, pos] = 3 + ((t - 3 + 1) % 95 if 3 <= t < 98 else 0)
            out.append(dict(s, trocr_tokens=toks))
    return out


def plant(name: str, samples: List[Dict], seed: int, engine: str,
          max_dets: int, px: float = 2.0) -> List[Dict]:
    if name == "box_shift":
        return box_shift(samples, px)
    return token(samples, seed, engine, max_dets)
