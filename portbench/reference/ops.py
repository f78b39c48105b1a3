"""Plain versions of the small steps around the models: decoding a clip's
sampled frames, I420 to BGR, the crops, greedy CTC, the TrOCR crops'
normalisation, and the host's assembly of a frame's answers.

``decode_shipped`` states what a batch of shipped frames must hold: every
``max(1, int(fps / target_fps))``-th frame of the clip (candidate ``n`` is
source frame ``n * interval``), resized with ``cv2.INTER_LINEAR`` to the
shipped size, as I420 (``cv2.COLOR_BGR2YUV_I420``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

CRNN_CHARS = (
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~ "
)
CRNN_BLANK, CRNN_UNK = 0, len(CRNN_CHARS) + 1
# the character tokenizer of the TrOCR path: 0 pad, 1 bos, 2 eos
TROCR_PAD, TROCR_BOS, TROCR_EOS = 0, 1, 2


def decode_shipped(path: str, numbers: Sequence[int], target_fps: float,
                   size_wh) -> Dict[int, np.ndarray]:
    """{candidate number: I420 frame} for the candidates ``numbers``."""
    import cv2

    want = set(int(n) for n in numbers)
    out: Dict[int, np.ndarray] = {}
    cap = cv2.VideoCapture(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
        interval = max(1, int(fps / target_fps)) if fps > 0 else 1
        src = 0
        while len(out) < len(want) and cap.grab():
            if src % interval == 0 and src // interval in want:
                ok, frame = cap.retrieve()
                if not ok:
                    break
                frame = cv2.resize(frame, tuple(size_wh),
                                   interpolation=cv2.INTER_LINEAR)
                out[src // interval] = cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420)
            src += 1
    finally:
        cap.release()
    return out


def i420_to_bgr(frames: np.ndarray) -> np.ndarray:
    """[B, H*3/2, W] uint8 I420 -> [B, H, W, 3] uint8 BGR (cv2's BT.601)."""
    import cv2

    return np.stack([cv2.cvtColor(f, cv2.COLOR_YUV2BGR_I420) for f in frames])


def crops(bgr: torch.Tensor, boxes: torch.Tensor, out_h: int,
          out_w: int) -> torch.Tensor:
    """Bilinear crops of boxes [N, 4] (x1, y1, x2, y2, frame coordinates)
    from one frame per box (``bgr`` [N, H, W, 3] uint8) -> [N, out_h,
    out_w, 3] in [0, 1], float64. The sample grid is cv2.resize's over the
    box: src = (dst + 0.5) * extent / out - 0.5 + origin, clamped to the
    frame, with extents at least one pixel."""
    n, h, w = bgr.shape[:3]
    b = boxes.double()
    bw = (b[:, 2] - b[:, 0]).clamp(min=1.0)
    bh = (b[:, 3] - b[:, 1]).clamp(min=1.0)
    gy = (torch.arange(out_h, dtype=torch.float64, device=b.device) + 0.5) / out_h
    gx = (torch.arange(out_w, dtype=torch.float64, device=b.device) + 0.5) / out_w
    yq = (gy[None] * bh[:, None] + b[:, 1:2] - 0.5).clamp(0, h - 1)
    xq = (gx[None] * bw[:, None] + b[:, 0:1] - 0.5).clamp(0, w - 1)
    y0 = yq.floor().long()
    x0 = xq.floor().long()
    fy = (yq - y0)[:, :, None, None]
    fx = (xq - x0)[:, None, :, None]
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    img = bgr.double()
    idx = torch.arange(n, device=b.device)[:, None, None]

    def at(yy, xx):
        return img[idx, yy[:, :, None], xx[:, None, :]]

    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return (top * (1 - fy) + bot * fy) / 255.0


def ctc_greedy(ids: np.ndarray) -> List[str]:
    """[N, T] per-step argmax ids -> strings: drop repeats, blanks and
    <unk>, map 1..95 to the printable characters."""
    out = []
    for row in ids:
        prev = -1
        chars = []
        for i in row:
            i = int(i)
            if i != prev and i not in (CRNN_BLANK, CRNN_UNK) and 1 <= i <= len(CRNN_CHARS):
                chars.append(CRNN_CHARS[i - 1])
            prev = i
        out.append("".join(chars))
    return out


def trocr_text(tokens) -> str:
    """Character tokens up to the first <eos>, pad and bos dropped; ids
    3.. are the printable characters, larger ids have no character."""
    out = []
    for t in tokens:
        t = int(t)
        if t == TROCR_EOS:
            break
        if 3 <= t < 3 + len(CRNN_CHARS):
            out.append(CRNN_CHARS[t - 3])
    return "".join(out)


def frame_answers(det: np.ndarray, texts: Dict[int, str], frame: int,
                  max_dets: int, map_size: int, orig_hw) -> List[tuple]:
    """The answers of one frame from its detection rows ``det`` [K, >=14]
    (box 4, polygon 8, score, valid) and the transcripts by flat slot:
    each valid slot whose box, scaled to the source frame and truncated to
    ints, spans more than 10 pixels both ways, as (bbox, text), in slot
    order."""
    h, w = orig_hw
    sx, sy = w / map_size, h / map_size
    out = []
    for j in range(max_dets):
        if det[j, 13] <= 0.5:
            continue
        bx = (det[j, 0:4].astype(np.float64) * np.array([sx, sy, sx, sy])).astype(np.int64)
        if bx[2] - bx[0] > 10 and bx[3] - bx[1] > 10:
            out.append((bx.tolist(), texts.get(frame * max_dets + j, "")))
    return out
