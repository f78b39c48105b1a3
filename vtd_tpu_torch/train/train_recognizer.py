"""CLI: train the CRNN recognizer with CTC loss (port of
``vtd_tpu/train/train_recognizer.py``), with the synthetic text-line
generator for runs without data on disk.

Usage:
  python -m vtd_tpu_torch train-recognizer --synthetic --epochs 10 \
      --checkpoint-dir ./checkpoints/crnn [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import logging

import numpy as np


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--n-samples", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--weight-decay", type=float, default=1e-5)
    parser.add_argument("--checkpoint-dir", default="./checkpoints/crnn")
    parser.add_argument(
        "--no-augment", action="store_true",
        help="disable on-device photometric augmentation",
    )
    parser.add_argument(
        "--data", default="", help="npz with images [N,32,128,3] + texts"
    )
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .recognizer_trainer import RecognizerTrainer, synthesize_text_lines

    if args.synthetic or not args.data:
        images, texts = synthesize_text_lines(args.n_samples)
    else:
        blob = np.load(args.data, allow_pickle=True)
        images = blob["images"]
        texts = list(blob["texts"])

    split = max(len(images) * 4 // 5, 1)
    trainer = RecognizerTrainer(
        {
            "checkpoint_dir": args.checkpoint_dir,
            "max_epochs": args.epochs,
            "batch_size": args.batch_size,
            "learning_rate": args.learning_rate,
            "weight_decay": args.weight_decay,
            "augment": not args.no_augment,
        },
        device=args.device,
    )
    result = trainer.train(
        images[:split], texts[:split], images[split:], texts[split:]
    )
    print(json.dumps({k: v for k, v in result.items() if k != "history"}))
    return result


if __name__ == "__main__":
    main()
