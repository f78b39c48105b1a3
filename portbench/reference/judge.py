"""Hold what the timed path produced against the plain reference.

A *sample* is one batch that the timed window drove, drawn from the seed
(``taps.Taps``), with what the program produced for it at each layer:
the I420 frames it shipped, the BGR frames its detector read, its
probability maps, its postprocess's boxes, scores and valid slots, the
detection rows of its pack, the crops and logits of its recognizer (CRNN)
or the crops, slots, tokens and confidences of its decoder (TrOCR), the
pack the host read, and the answers the host made of it.

The reference works each layer out again: it decodes the clip itself,
turns I420 into BGR with cv2, runs DBNet in float32 on its own frames,
and postprocesses, crops and recognises in plain code. Where a layer's
input is the program's own output (the postprocess reads the program's
map, the crops the program's boxes, the decoders score the program's
tokens, the host's answers are rebuilt from the program's pack), the
layer before it is held on its own, so every layer is checked once:

  decode_max_abs       shipped I420 bytes against the clip decoded here
  bgr_max_abs          the detector's BGR input against cv2's I420 -> BGR
  prob_max_abs         probability maps against float32 DBNet
  post_valid_mismatch  valid slots against the plain postprocess of the
                       program's map
  post_iou_gap         1 - IoU of each box valid on both sides, against
                       the nearest box of a rectangle within 1 % of the
                       least area (``postprocess.boxes_near``)
  post_score_max_abs   each valid slot's score against the mean of the
                       map over its box
  crop_max_abs         the recognizer's input crops against plain crops of
                       the program's boxes from the reference's frames
  logit_max_abs        the CRNN's logits against float32 CRNN logits of the
                       reference's crops (TrOCR: not read, 0)
  logit_gap_max        the widest gap by which the logit of a token the
                       program emitted lies below the reference's best, at
                       each CTC step of each recognised slot (CRNN) or each
                       decode step up to the first <eos> (TrOCR, teacher-
                       forced on the program's tokens)
  conf_rel_gap_mean    TrOCR: each decoded crop's confidence (the mean,
                       over the decode steps up to the first <eos>, of the
                       largest softmax probability) against the same
                       worked out from the reference's teacher-forced
                       logits, as a share of the reference's; the mean
                       over every decoded crop of the samples (CRNN: not
                       read, 0). The widest crop's, ``conf_rel_gap_max``,
                       is read beside it with that crop's reference
                       confidence and steps, and held to no limit: it is
                       set by one crop and swings from seed to seed
  answer_mismatch      answers (box in source pixels, transcript) of each
                       frame that differ from those rebuilt from the pack

Readings are maxima over the samples; ``limits`` in the configuration's
file holds each one's limit, and ``verdict`` is the comparison that
decides ``correct``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from . import models as M
from . import ops
from .postprocess import box_score, iou, postprocess

NAMES = ("decode_max_abs", "bgr_max_abs", "prob_max_abs", "post_valid_mismatch",
         "post_iou_gap", "post_score_max_abs", "crop_max_abs", "logit_max_abs",
         "logit_gap_max", "conf_rel_gap_mean", "answer_mismatch")


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each limited number with its reading, its limit and whether it holds."""
    return {k: {"value": float(readings[k]), "limit": lim,
                "ok": bool(float(readings[k]) <= lim)} for k, lim in limits.items()}


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: PyTorch on the card may run them in
    TF32, a lower precision, unless told not to."""
    held = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = held


class Reference:
    """The reference's weights on ``device`` and the configuration's
    sizes. ``recognizer``: the CRNN's flax tree, or the TrOCR dict."""

    def __init__(self, cfg: Dict, detector_vars, recognizer, device):
        self.cfg = cfg
        self.device = device
        self.det_v = M.to_device(detector_vars, device)
        self.engine = cfg["recognizer"]["engine"]
        if self.engine == "crnn":
            self.rec = M.to_device(recognizer, device)
        else:
            self.rec = {k: v.to(device=device, dtype=torch.float32)
                        for k, v in recognizer.items()}
        p = cfg["pipeline"]
        self.size = int(p.get("detector_input_size", 640))
        self.max_dets = int(p.get("max_dets", 64))
        self.thresh = float(p.get("confidence_threshold", 0.5))
        self.box_frac = float(p.get("max_box_frac", 0.95))

    # -- the layers, each from its own input ------------------------------
    def probability(self, bgr: np.ndarray, q=M.identity) -> torch.Tensor:
        out = []
        for i in range(0, len(bgr), 4):  # blocks of 4 frames keep it small
            x = M.detector_input(torch.as_tensor(bgr[i:i + 4], device=self.device),
                                 self.size)
            out.append(M.dbnet_probability(x, self.det_v, q))
        return torch.cat(out)

    def crnn_logits(self, crops: torch.Tensor, q_conv=M.identity,
                    q_rnn=M.identity) -> torch.Tensor:
        return torch.cat([M.crnn_logits(crops[i:i + 256].float(), self.rec,
                                        q_conv, q_rnn)
                          for i in range(0, len(crops), 256)]) if len(crops) else \
            torch.zeros(0, 31, 97, device=self.device)

    def trocr_logits(self, images: torch.Tensor, prefix: torch.Tensor,
                     q=M.identity) -> torch.Tensor:
        tc = self.cfg["recognizer"]["trocr"]
        out = []
        for i in range(0, len(images), 8):
            enc = M.trocr_encode(images[i:i + 8].float(), self.rec, tc, q)
            out.append(M.trocr_decode(prefix[i:i + 8], enc, self.rec, tc, q))
        return torch.cat(out)


def _scale(sample) -> np.ndarray:
    h, w = sample["bgr"].shape[1:3]
    s = sample["size"]
    return np.array([w / s, h / s, w / s, h / s])


def _selected(det: np.ndarray, n: int) -> np.ndarray:
    """The flat slots the CRNN read: all, or the top ``n`` by (valid, score)
    with the lower slot first on ties."""
    flat = det.reshape(-1, det.shape[-1])
    if n >= len(flat):
        return np.arange(len(flat))
    key = flat[:, 13].astype(np.float32) * np.float32(2.0) + flat[:, 12].astype(np.float32)
    return np.argsort(-key, kind="stable")[:n]


def _pack_rows(pack: np.ndarray, engine: str, pack_dtype) -> tuple:
    """The pack the host read -> (det rows [B, K, 14 or 15], CTC ids or None)."""
    nf = 14 if engine == "trocr" else 15
    item = np.dtype(pack_dtype).itemsize
    det = np.ascontiguousarray(pack[..., :item * nf]).view(pack_dtype).astype(np.float32)
    ids = None if engine == "trocr" else pack[..., item * nf:].astype(np.int64)
    return det, ids


def gaps(logits: torch.Tensor, tokens: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> float:
    """Widest ``max(logits) - logits[token]`` over the positions in ``mask``."""
    if logits.numel() == 0:
        return 0.0
    best = logits.amax(-1)
    got = logits.gather(-1, tokens.long().unsqueeze(-1)).squeeze(-1)
    gap = best - got
    if mask is not None:
        gap = torch.where(mask, gap, torch.zeros_like(gap))
    return float(gap.max())


def confidences(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The decoder's confidence a crop: the mean over ``mask`` of each
    step's largest softmax probability -> [N]."""
    pmax = torch.softmax(logits.float(), -1).amax(-1)
    return (pmax * mask).sum(1) / mask.sum(1).clamp_min(1)


def rel_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``|got - want| / want``, element by element, in float64."""
    return (got.double() - want.double()).abs() / want.double()


def conf_readings(gaps_: List[torch.Tensor], want: List[torch.Tensor],
                  steps: List[torch.Tensor]) -> Dict[str, float]:
    """The mean and the widest of the crops' relative confidence gaps, and
    the widest crop's reference confidence and decode steps."""
    if not gaps_ or not sum(g.numel() for g in gaps_):
        return {"conf_rel_gap_mean": 0.0, "conf_rel_gap_max": 0.0}
    g, w, n = (torch.cat([t.double().cpu() for t in x]) for x in (gaps_, want, steps))
    i = int(g.argmax())
    return {"conf_rel_gap_mean": float(g.mean()), "conf_rel_gap_max": float(g[i]),
            "conf_rel_gap_max_conf": float(w[i]), "conf_rel_gap_max_steps": float(n[i])}


def trocr_positions(tokens: torch.Tensor) -> tuple:
    """(the decoder's inputs [N, T], the positions up to the first <eos>)."""
    n, t = tokens.shape
    bos = torch.full((n, 1), ops.TROCR_BOS, dtype=torch.int64, device=tokens.device)
    prefix = torch.cat([bos, tokens[:, :-1].long()], 1)
    is_eos = tokens == ops.TROCR_EOS
    first = torch.where(is_eos.any(1), is_eos.int().argmax(1), t - 1)
    mask = torch.arange(t, device=tokens.device)[None] <= first[:, None]
    return prefix, mask


def judge(samples: List[Dict], ref: Reference) -> Dict[str, float]:
    """Every reading of ``NAMES`` over ``samples`` (maxima)."""
    out = {k: 0.0 for k in NAMES}
    conf = ([], [], [])  # per crop: relative gap, reference confidence, steps
    dev = ref.device
    k = ref.max_dets
    for s in samples:
        clip, numbers, valid, orig_hw = s["origin"]
        b = len(numbers)
        shipped = s["frames"]
        ship_wh = (shipped.shape[2], shipped.shape[1] * 2 // 3)
        decoded = ops.decode_shipped(clip, sorted(set(numbers.tolist())),
                                     s["target_fps"], ship_wh)
        mine = np.stack([decoded[int(n)] for n in numbers])
        rows = np.nonzero(valid)[0]
        out["decode_max_abs"] = max(out["decode_max_abs"], float(np.abs(
            mine[rows].astype(np.int16) - shipped[rows].astype(np.int16)).max()))
        bgr = ops.i420_to_bgr(mine)
        out["bgr_max_abs"] = max(out["bgr_max_abs"], float(np.abs(
            bgr.astype(np.int16) - s["bgr"].astype(np.int16)).max()))

        prob = ref.probability(bgr)
        port_prob = s["prob"].to(dev).float()
        out["prob_max_abs"] = max(out["prob_max_abs"],
                                  float((prob - port_prob).abs().max()))

        pp = port_prob.cpu().numpy()
        post = s["post"]
        for i in range(b):
            mine_pp = postprocess(pp[i], ref.thresh, k, 100.0, ref.box_frac)
            pv = post["valid"][i]
            mism = int((mine_pp["valid"] != pv).sum())
            out["post_valid_mismatch"] = max(out["post_valid_mismatch"], float(mism))
            for j in np.nonzero(pv & mine_pp["valid"])[0]:
                box = post["boxes"][i, j].astype(np.float64)
                out["post_iou_gap"] = max(out["post_iou_gap"], 1.0 - max(
                    iou(box, near) for near in mine_pp["near"][j]))
            for j in np.nonzero(pv)[0]:
                out["post_score_max_abs"] = max(out["post_score_max_abs"], abs(
                    float(post["scores"][i, j]) - box_score(pp[i], post["boxes"][i, j])))

        det = s["det"]  # [B, K, 14] float32 as the device computed it
        scale = _scale(s)
        bgr_t = torch.as_tensor(bgr, device=dev)
        if ref.engine == "crnn":
            port_crops = s["crnn_crops"].to(dev)
            sel = _selected(det, len(port_crops))
            boxes = torch.as_tensor(det.reshape(-1, 14)[sel, :4] * scale, device=dev)
            my_crops = ops.crops(bgr_t[torch.as_tensor(sel // k, device=dev)], boxes, 32, 128)
            live = torch.as_tensor(det.reshape(-1, 14)[sel, 13] > 0.5, device=dev)
            my_crops = torch.where(live[:, None, None, None], my_crops, 0.0)
            if len(sel):
                out["crop_max_abs"] = max(out["crop_max_abs"], float(
                    (my_crops - port_crops.double()).abs().max()))
            logits = ref.crnn_logits(my_crops.float())
            if len(sel):
                out["logit_max_abs"] = max(out["logit_max_abs"], float(
                    (logits - s["crnn_logits"].to(dev).float()).abs().max()))
            _, ids = _pack_rows(s["pack"], "crnn", s["pack_dtype"])
            port_ids = torch.as_tensor(ids.reshape(b * k, -1)[sel], device=dev)
            out["logit_gap_max"] = max(out["logit_gap_max"], gaps(logits, port_ids))
        elif s.get("need") is not None:
            need = np.asarray(s["need"], np.int64)
            tc = ref.cfg["recognizer"]["trocr"]
            hw = tc["image_size"]
            boxes = torch.as_tensor(det.reshape(-1, 14)[need, :4] * scale, device=dev)
            my = ops.crops(bgr_t[torch.as_tensor(need // k, device=dev)], boxes, hw, hw)
            my = ((my.flip(-1) - 0.5) / 0.5).float()
            port_in = s["trocr_crops"].to(dev).float()
            if len(need):
                out["crop_max_abs"] = max(out["crop_max_abs"], float(
                    (my - port_in).abs().max()))
                toks = s["trocr_tokens"].to(dev)
                prefix, mask = trocr_positions(toks)
                logits = ref.trocr_logits(my, prefix)
                out["logit_gap_max"] = max(out["logit_gap_max"],
                                           gaps(logits, toks, mask))
                want = confidences(logits, mask)
                conf[0].append(rel_gaps(s["trocr_confs"].to(dev), want))
                conf[1].append(want)
                conf[2].append(mask.sum(1))
        if s.get("results") is not None:
            out["answer_mismatch"] = max(out["answer_mismatch"],
                                         float(answer_mismatch(s, ref)))
    out.update(conf_readings(*conf))
    return out


def answer_mismatch(s: Dict, ref: Reference) -> int:
    """Answers of the sample's frames that differ from those rebuilt from
    the pack the host read."""
    pack = s.get("redo_pack", s["pack"])
    det16, ids = _pack_rows(pack, ref.engine, s["pack_dtype"])
    k = ref.max_dets
    clip, numbers, valid, orig_hw = s["origin"]
    b = len(numbers)
    texts: Dict[int, str] = {}
    if ref.engine == "crnn":
        flat_ids = ids.reshape(b * k, -1)
        for flat, t in zip(range(b * k), ops.ctc_greedy(flat_ids)):
            texts[flat] = t
    else:
        toks = s["trocr_tokens"].cpu().numpy() if s.get("need") is not None else []
        for flat, row in zip(s.get("need") or [], toks):
            texts[int(flat)] = ops.trocr_text(row)
    bad = 0
    for i in np.nonzero(valid)[0]:
        want = ops.frame_answers(det16[i], texts, int(i), k, ref.size, orig_hw)
        got = [(d["bbox"], d["text"]) for d in s["results"][int(i)]]
        if want != got:
            bad += max(len(want), len(got), 1)
    return bad
