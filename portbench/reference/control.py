"""The control: the reference, one step below the precision the
configuration states, put in the program's place one layer at a time.

The configurations state bfloat16 for DBNet, the CRNN's convolutions and
every TrOCR projection, and float32 for the CRNN's LSTM and classifier.
One step below is fp8 (e4m3, one scale a tensor from its largest
magnitude) for the former and bfloat16 for the latter. Every convolution
and matrix product of the reference rounds both operands so.

``readings`` gives, for each layer the control can take over, the
numbers that layer moves, each taken as ``judge.judge`` takes the
program's:

  detector    ``prob_max_abs``: fp8 DBNet on the reference's frames
              against float32 DBNet
  recognizer  on the same crops (and, for TrOCR, the program's tokens as
              the decoder's inputs): the CRNN's widest logit difference
              (``logit_max_abs``), the widest gap of the tokens the lower
              precision puts first (``logit_gap_max``) and, for TrOCR, the
              confidences it would report (``conf_rel_gap_mean``, and
              ``conf_rel_gap_max`` beside it)

The other numbers of a layer's reading are the program's, as the layer
alone stands in for the program's; ``judge.verdict`` then decides which
limits the control fails.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import ops
from .judge import (
    Reference, _scale, _selected, conf_readings, confidences, gaps, rel_gaps,
    trocr_positions,
)


def fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    s = 448.0 / amax
    return ((x.float() * s).to(torch.float8_e4m3fn).float() / s).to(x.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def readings(samples: List[Dict], ref: Reference) -> Dict[str, Dict[str, float]]:
    det_out = {"prob_max_abs": 0.0}
    rec_out = {"logit_max_abs": 0.0, "logit_gap_max": 0.0}
    conf = ([], [], [])
    dev = ref.device
    k = ref.max_dets
    for s in samples:
        clip, numbers, valid, _ = s["origin"]
        shipped = s["frames"]
        ship_wh = (shipped.shape[2], shipped.shape[1] * 2 // 3)
        decoded = ops.decode_shipped(clip, sorted(set(numbers.tolist())),
                                     s["target_fps"], ship_wh)
        bgr = ops.i420_to_bgr(np.stack([decoded[int(n)] for n in numbers]))
        prob = ref.probability(bgr)
        low = ref.probability(bgr, fp8)
        det_out["prob_max_abs"] = max(det_out["prob_max_abs"],
                                      float((low - prob).abs().max()))
        det = s["det"]
        scale = _scale(s)
        bgr_t = torch.as_tensor(bgr, device=dev)
        if ref.engine == "crnn":
            sel = _selected(det, len(s["crnn_crops"]))
            boxes = torch.as_tensor(det.reshape(-1, 14)[sel, :4] * scale, device=dev)
            crops = ops.crops(bgr_t[torch.as_tensor(sel // k, device=dev)],
                              boxes, 32, 128).float()
            live = torch.as_tensor(det.reshape(-1, 14)[sel, 13] > 0.5, device=dev)
            crops = torch.where(live[:, None, None, None], crops, 0.0)
            want = ref.crnn_logits(crops)
            low = ref.crnn_logits(crops, fp8, bf16)
            if len(sel):
                rec_out["logit_max_abs"] = max(rec_out["logit_max_abs"],
                                               float((low - want).abs().max()))
            rec_out["logit_gap_max"] = max(rec_out["logit_gap_max"],
                                           gaps(want, low.argmax(-1)))
        elif s.get("need") is not None and len(s["need"]):
            need = np.asarray(s["need"], np.int64)
            hw = ref.cfg["recognizer"]["trocr"]["image_size"]
            boxes = torch.as_tensor(det.reshape(-1, 14)[need, :4] * scale, device=dev)
            my = ops.crops(bgr_t[torch.as_tensor(need // k, device=dev)], boxes, hw, hw)
            my = ((my.flip(-1) - 0.5) / 0.5).float()
            prefix, mask = trocr_positions(s["trocr_tokens"].to(dev))
            want = ref.trocr_logits(my, prefix)
            low = ref.trocr_logits(my, prefix, fp8)
            rec_out["logit_gap_max"] = max(rec_out["logit_gap_max"],
                                           gaps(want, low.argmax(-1), mask))
            ref_conf = confidences(want, mask)
            conf[0].append(rel_gaps(confidences(low, mask), ref_conf))
            conf[1].append(ref_conf)
            conf[2].append(mask.sum(1))
    if ref.engine != "crnn":
        del rec_out["logit_max_abs"]
        rec_out.update(conf_readings(*conf))
    return {"detector": det_out, "recognizer": rec_out}
