"""Refresh a report's ``e2e``, ``e2e_transformer`` and ``trocr`` sections.

    python -m vtd_tpu_torch.tools.update_report [--report R] [--out O] \
        [--detector D] [--crnn C] [--trocr T] [--trocr-log LOG] \
        [--device cuda|cpu]

Runs both engines on the HELLO / WORLD / 123 verify clip
(``examples/verify_checkpoints.py``: the shipped frame, confidence 0.5,
batch 8) with the given checkpoints and records each summary; the
``trocr`` section comes from the last line of a finished ``train-trocr``
log that starts with ``{`` and names ``heldout``. Every other section of
the report is kept as it is. The report is read from ``--report`` (the
repo's ``demo_models2/report.json``) and written to ``--out`` (by default
under ``vtd_tpu_torch/.report_out/``, which git ignores), never over the
committed file unless asked. Prints the card's name and power limit, one
JSON line per section written and ``REPORT UPDATED``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..examples import verify_checkpoints
from ..examples.train_and_verify import e2e_report
from ..examples.verify_checkpoints import TRUTH

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(_REPO, "vtd_tpu_torch", ".report_out")


def run_engine(detector: str, recognizer: str, transformer: bool,
               device: str = "cuda") -> dict:
    """One engine's section: the verify clip's summary, and with the CRNN
    the mean detection confidence of every detection."""
    result = verify_checkpoints.run_clip(detector, recognizer, transformer,
                                         device)
    out = e2e_report(result)
    out["clean"] = set(result["summary"]["detected_texts"]) == set(TRUTH)
    if not transformer:
        confs = [
            d["detection_confidence"]
            for fr in result["results"]
            for d in fr["detections"]
        ]
        out["avg_det_conf"] = round(float(np.mean(confs)), 3) if confs else 0.0
    return out


def trocr_section(log_path: str) -> dict | None:
    """The ``trocr`` section from a ``train-trocr`` log's last JSON line
    naming ``heldout``; None when there is none."""
    last = None
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and "heldout" in line:
                last = json.loads(line)
    if not last:
        return None
    return {
        "checkpoint": last.get("best_model_path"),
        "final_loss": last.get("final_loss"),
        "epochs": last.get("epochs_trained"),
        "heldout_exact_match_random8":
            last.get("heldout_exact_match_random8"),
        "heldout_char_accuracy_random8":
            last.get("heldout_char_accuracy_random8"),
    }


def main(argv=None) -> int:
    from ..bench import card_fields

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report",
                    default=os.path.join(_REPO, "demo_models2/report.json"))
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "report.json"),
                    help="where the updated report is written")
    ap.add_argument("--detector",
                    default=os.path.join(_REPO, "demo_models2/dbnet/best_bf16"))
    ap.add_argument("--crnn",
                    default=os.path.join(_REPO, "demo_models2/crnn/crnn_final"))
    ap.add_argument("--trocr",
                    default=os.path.join(_REPO, "models/text_recognizer_trocr"))
    ap.add_argument("--trocr-log", default="",
                    help="train-trocr log; its final JSON line refreshes "
                         "the trocr section")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    card = card_fields(args.device)
    print("device:", args.device if card["card_name"] is None
          else f"{card['card_name']}, {card['power_limit']}", flush=True)
    with open(args.report) as f:
        report = json.load(f)

    report["e2e"] = run_engine(args.detector, args.crnn, False, args.device)
    print(json.dumps({"e2e": report["e2e"]}), flush=True)
    report["e2e_transformer"] = run_engine(args.detector, args.trocr, True,
                                           args.device)
    print(json.dumps({"e2e_transformer": report["e2e_transformer"]}),
          flush=True)

    if args.trocr_log and os.path.exists(args.trocr_log):
        section = trocr_section(args.trocr_log)
        if section:
            report["trocr"] = section
            print(json.dumps({"trocr": report["trocr"]}), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("REPORT UPDATED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
