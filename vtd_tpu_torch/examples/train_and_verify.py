"""End-to-end demo: train on synthetic data, then read a clip.

    python -m vtd_tpu_torch.examples.train_and_verify [--quick] \
        [--out ./demo_models] [--detector-ckpt PATH] [--trocr-ckpt PATH] \
        [--device cuda|cpu]

Trains the CRNN recognizer (CTC) and the DBNet detector (float32, 320x320)
from scratch on procedurally generated data with the port's
``RecognizerTrainer`` and ``ModelTrainer``, then runs the pipeline on a
fresh clip with HELLO, WORLD and 123 burned in and reports what it read.
``--detector-ckpt`` reuses a detector checkpoint instead of training one;
``--trocr-ckpt`` also reads the clip with the transformer recognizer from
that checkpoint. Writes ``report.json`` under ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .verify_checkpoints import TRUTH, run_clip

WORDS = ["HELLO", "WORLD", "VIDEO", "TEXT", "DETECT", "TPU", "JAX",
         "FRAME", "OCR", "FAST", "123", "2026"]


def make_detection_dataset(n: int, size: int, seed: int):
    """Frames with randomly placed words and their DB label maps."""
    import cv2
    import torch

    from ..train.labels import make_maps

    rng = np.random.default_rng(seed)
    images = np.zeros((n, size, size, 3), np.float32)
    probs, threshs = [], []
    for i in range(n):
        shade = int(rng.integers(160, 255))
        img = np.full((size, size, 3), shade, np.uint8)
        cv2.circle(
            img,
            (int(rng.integers(0, size)), int(rng.integers(0, size))),
            int(rng.integers(20, 80)),
            (shade - 30, shade - 20, shade - 10), -1,
        )
        boxes = []
        for _ in range(int(rng.integers(1, 4))):
            word = WORDS[int(rng.integers(len(WORDS)))]
            scale = float(rng.uniform(0.9, 2.0))
            thick = 2 if scale < 1.4 else 3
            (tw, th), base = cv2.getTextSize(
                word, cv2.FONT_HERSHEY_SIMPLEX, scale, thick
            )
            if tw >= size - 20:
                continue
            x = int(rng.integers(5, size - tw - 5))
            y = int(rng.integers(th + 5, size - 5))
            cv2.putText(
                img, word, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale,
                (0, 0, 0), thick,
            )
            boxes.append([x, y - th, x + tw, y + base])
        images[i] = img.astype(np.float32) / 255.0
        arr = np.zeros((8, 4), np.float32)
        valid = np.zeros(8, bool)
        for j, bx in enumerate(boxes[:8]):
            arr[j] = bx
            valid[j] = True
        p, t = make_maps(torch.from_numpy(arr), torch.from_numpy(valid),
                         size, size)
        probs.append(p.numpy())
        threshs.append(t.numpy())
    return images, {
        "probability_map": np.stack(probs),
        "threshold_map": np.stack(threshs),
    }


def e2e_report(result: dict) -> dict:
    s = result["summary"]
    detected = set(s["detected_texts"])
    return {
        "frames": s["total_frames"],
        "detections": s["total_detections"],
        "detected_texts": sorted(detected)[:10],
        "truth": TRUTH,
        "exact_matches": sum(1 for t in TRUTH if t in detected),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--out", default="./demo_models")
    parser.add_argument(
        "--detector-ckpt", default="",
        help="reuse an existing detector checkpoint (skip detector training)",
    )
    parser.add_argument(
        "--trocr-ckpt", default="",
        help="also run the e2e verification with the transformer "
             "recognizer loaded from this checkpoint (e.g. "
             "demo_models2/trocr/trocr_final)",
    )
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from ..models.dbnet import DBNet
    from ..train.recognizer_trainer import (
        RecognizerTrainer,
        synthesize_text_lines,
    )
    from ..train.trainer import ModelTrainer, TextDetectionDataset

    os.makedirs(args.out, exist_ok=True)
    report = {}

    print("=== training CRNN recognizer (CTC) ===", flush=True)
    n_lines = 512 if args.quick else 4096
    epochs = 6 if args.quick else 25
    imgs, texts = synthesize_text_lines(n_lines, seed=0)
    vimgs, vtexts = synthesize_text_lines(256, seed=99)
    t0 = time.time()
    rec_result = RecognizerTrainer(
        {
            "checkpoint_dir": os.path.join(args.out, "crnn"),
            "max_epochs": epochs,
            "batch_size": 128,
            "learning_rate": 1e-3,
        },
        device=args.device,
    ).train(imgs, texts, vimgs, vtexts)
    if rec_result["status"] != "success":
        raise RuntimeError(f"CRNN training failed: {rec_result}")
    report["crnn"] = {
        "train_seconds": round(time.time() - t0, 1),
        "final_loss": rec_result["final_loss"],
        **{
            k: rec_result["history"][-1][k]
            for k in ("val_exact_match", "val_char_accuracy")
        },
    }
    print(json.dumps(report["crnn"]), flush=True)

    det_size = 320
    if args.detector_ckpt:
        print("=== reusing detector checkpoint ===", flush=True)
        detector_ckpt = args.detector_ckpt
        report["dbnet"] = {"reused": detector_ckpt}
    else:
        print("=== training DBNet detector ===", flush=True)
        n_det = 64 if args.quick else 384
        det_epochs = 4 if args.quick else 20
        images, targets = make_detection_dataset(n_det, det_size, seed=1)
        split = n_det * 7 // 8
        t0 = time.time()
        det_result = ModelTrainer(
            {
                "checkpoint_dir": os.path.join(args.out, "dbnet"),
                "max_epochs": det_epochs,
                "batch_size": 8,
                "learning_rate": 3e-4,
                "early_stop_patience": 10,
            },
            device=args.device,
        ).train(
            DBNet(),  # float32
            TextDetectionDataset(
                images[:split], {k: v[:split] for k, v in targets.items()}
            ),
            TextDetectionDataset(
                images[split:], {k: v[split:] for k, v in targets.items()}
            ),
        )
        if det_result["status"] != "success":
            raise RuntimeError(f"DBNet training failed: {det_result}")
        detector_ckpt = det_result["best_model_path"]
        report["dbnet"] = {
            "train_seconds": round(time.time() - t0, 1),
            "best_val_loss": det_result["best_val_loss"],
            "val_f1": det_result["history"][-1]["val_f1"],
            "ckpt": detector_ckpt,
        }
    print(json.dumps(report["dbnet"]), flush=True)

    print("=== end-to-end verification on a fresh clip ===", flush=True)
    result = run_clip(detector_ckpt, rec_result["best_model_path"], False,
                      args.device, detector_input_size=det_size)
    report["e2e"] = {
        **e2e_report(result),
        "avg_det_conf": round(result["summary"]["avg_detection_confidence"],
                              3),
    }
    print(json.dumps(report["e2e"], indent=1), flush=True)

    if args.trocr_ckpt:
        print("=== e2e verification, transformer recognizer ===", flush=True)
        result = run_clip(detector_ckpt, args.trocr_ckpt, True, args.device,
                          detector_input_size=det_size)
        report["e2e_transformer"] = e2e_report(result)
        print(json.dumps(report["e2e_transformer"], indent=1), flush=True)

    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print("REPORT WRITTEN", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
