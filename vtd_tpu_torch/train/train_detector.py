"""CLI: train the DBNet detector (port of
``vtd_tpu/train/train_detector.py``).

With ``--synthetic`` (or without ``--data``) it renders labelled frames
(text drawn with cv2, DB label maps from ``labels.make_maps``) from the
reference's numpy seeds, so the loop runs with no data on disk.

Usage:
  python -m vtd_tpu_torch train-detector --synthetic --epochs 5 \
      --checkpoint-dir ./checkpoints/dbnet [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import logging
from typing import List, Tuple

import numpy as np
import torch


def synthesize_detection_data(
    n: int, size: int = 160, seed: int = 0
) -> Tuple[np.ndarray, dict]:
    """Frames with random text [n, size, size, 3] in [0, 1] and their DB
    target maps; equal to the reference's for the same seed."""
    import cv2

    from .labels import make_maps

    rng = np.random.default_rng(seed)
    images = np.zeros((n, size, size, 3), np.float32)
    probs, threshs = [], []
    for i in range(n):
        img = np.full((size, size, 3), 255, np.uint8)
        boxes: List[List[float]] = []
        for _ in range(int(rng.integers(1, 4))):
            text = "".join(
                rng.choice(list("ABCDEFG0123456789"))
                for _ in range(int(rng.integers(3, 7)))
            )
            x = int(rng.integers(5, size // 2))
            y = int(rng.integers(20, size - 10))
            cv2.putText(
                img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1
            )
            (tw, th), _ = cv2.getTextSize(
                text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1
            )
            boxes.append([x, y - th, min(x + tw, size), min(y + 2, size)])
        images[i] = img.astype(np.float32) / 255.0
        arr = np.zeros((8, 4), np.float32)
        valid = np.zeros(8, bool)
        for j, b in enumerate(boxes[:8]):
            arr[j] = b
            valid[j] = True
        p, t = make_maps(torch.from_numpy(arr), torch.from_numpy(valid),
                         size, size)
        probs.append(p.numpy())
        threshs.append(t.numpy())
    targets = {
        "probability_map": np.stack(probs),
        "threshold_map": np.stack(threshs),
    }
    return images, targets


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--n-samples", type=int, default=64)
    parser.add_argument("--image-size", type=int, default=160)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--weight-decay", type=float, default=1e-5)
    parser.add_argument("--checkpoint-dir", default="./checkpoints/dbnet")
    parser.add_argument("--data", default="", help="npz with images/targets")
    parser.add_argument(
        "--mesh", default="",
        help="'DxM' data x model mesh: not ported yet (ROADMAP queue 1 "
             "item 7)",
    )
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..models.dbnet import DBNet
    from .trainer import MESH_NOT_PORTED, ModelTrainer, TextDetectionDataset

    if args.mesh:
        raise NotImplementedError(MESH_NOT_PORTED)
    if args.synthetic or not args.data:
        images, targets = synthesize_detection_data(
            args.n_samples, args.image_size
        )
    else:
        blob = np.load(args.data)
        images = blob["images"]
        targets = {
            "probability_map": blob["probability_map"],
            "threshold_map": blob["threshold_map"],
        }

    split = max(len(images) * 4 // 5, 1)
    train_ds = TextDetectionDataset(
        images[:split], {k: v[:split] for k, v in targets.items()}
    )
    val_ds = TextDetectionDataset(
        images[split:], {k: v[split:] for k, v in targets.items()}
    )
    trainer = ModelTrainer(
        {
            "checkpoint_dir": args.checkpoint_dir,
            "max_epochs": args.epochs,
            "batch_size": args.batch_size,
            "learning_rate": args.learning_rate,
            "weight_decay": args.weight_decay,
        },
        device=args.device,
    )
    result = trainer.train(DBNet(dtype=torch.float32), train_ds, val_ds)
    print(json.dumps({k: v for k, v in result.items() if k != "history"}))
    return result


if __name__ == "__main__":
    main()
