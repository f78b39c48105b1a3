"""Print every merged text track of the verify clip.

    python -m vtd_tpu_torch.tools.diag_tracks [--transformer] [--cpu] \
        [--detector PATH] [--crnn PATH] [--trocr PATH]

Runs the demo checkpoints' pipeline on the HELLO / WORLD / 123 clip of
``examples.verify_checkpoints`` and prints each track of
``temporal_dedup`` over the results (text, frame count, detection and
recognition confidences, box), whether it is one of the true strings,
and the spread of recognition confidences of true and junk reads: the
measured separation that the summary's confirmed-track filter is set
from. ``--cpu`` runs on the CPU (default: the card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..examples.verify_checkpoints import TRUTH, run_clip

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--transformer", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    parser.add_argument(
        "--detector",
        default=os.path.join(_REPO, "demo_models2/dbnet/best_bf16"))
    parser.add_argument(
        "--crnn", default=os.path.join(_REPO, "demo_models2/crnn/crnn_final"))
    parser.add_argument(
        "--trocr", default=os.path.join(_REPO, "models/text_recognizer_trocr"))
    args = parser.parse_args(argv)

    from ..ops.nms import temporal_dedup

    result = run_clip(
        args.detector, args.trocr if args.transformer else args.crnn,
        args.transformer, "cpu" if args.cpu else "cuda",
    )
    tracks = temporal_dedup(result["results"])
    tracks.sort(key=lambda t: (-t["count"], t["text"]))
    for t in tracks:
        t = dict(t)
        t["real"] = t["text"] in TRUTH
        print(json.dumps(t))
    real_conf, junk_conf = [], []
    for fr in result["results"]:
        for d in fr["detections"]:
            (real_conf if d["text"].strip() in TRUTH else junk_conf).append(
                round(float(d["recognition_confidence"]), 3)
            )
    print("real rec-conf:", f"n={len(real_conf)}",
          f"min={min(real_conf) if real_conf else None}",
          f"mean={np.mean(real_conf).round(3) if real_conf else None}")
    print("junk rec-conf:", f"n={len(junk_conf)}",
          f"max={max(junk_conf) if junk_conf else None}",
          f"mean={np.mean(junk_conf).round(3) if junk_conf else None}",
          sorted(junk_conf)[-8:] if junk_conf else [])
    return 0


if __name__ == "__main__":
    sys.exit(main())
