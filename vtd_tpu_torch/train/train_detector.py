"""CLI: train the DBNet detector (port of
``vtd_tpu/train/train_detector.py``).

With ``--synthetic`` (or without ``--data``) it renders labelled frames
(text drawn with cv2, DB label maps from ``labels.make_maps``) from the
reference's numpy seeds, so the loop runs with no data on disk.

Usage:
  python -m vtd_tpu_torch train-detector --synthetic --epochs 5 \
      --checkpoint-dir ./checkpoints/dbnet [--device cuda] [--mesh 2x2]
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


def _parser() -> argparse.ArgumentParser:
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
        help="'DxM' data x model mesh, e.g. 2x2: D data-parallel ranks, "
             "one process each, each splitting its model over its row of "
             "M devices (1xM trains in this process)",
    )
    parser.add_argument("--device", default="cuda")
    return parser


def _mesh_shape(text: str) -> Tuple[int, int]:
    d, m = (int(v) for v in text.lower().split("x"))
    if d < 1 or m < 1:
        raise ValueError(f"bad mesh {text!r}")
    return d, m


def train(args: argparse.Namespace) -> dict:
    """One training run of the command in this process (a rank of its
    group under ``--mesh``); returns the trainer's result."""
    from ..core.device import resolve_device
    from ..core.mesh import make_mesh
    from ..models.dbnet import DBNet
    from .trainer import ModelTrainer, TextDetectionDataset

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
    mesh = None
    if args.mesh:
        # rank r trains on row r; on the card the entries wrap around the
        # visible cards
        d, m = _mesh_shape(args.mesh)
        dev = resolve_device(args.device)
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        mesh = make_mesh(n_data=d, n_model=m, devices=[
            torch.device("cuda", i % n_cards) if n_cards else dev
            for i in range(d * m)])
    trainer = ModelTrainer(
        {
            "checkpoint_dir": args.checkpoint_dir,
            "max_epochs": args.epochs,
            "batch_size": args.batch_size,
            "learning_rate": args.learning_rate,
            "weight_decay": args.weight_decay,
        },
        mesh=mesh,
        device=args.device,
    )
    return trainer.train(DBNet(dtype=torch.float32), train_ds, val_ds)


def _rank_train(rank: int, args: argparse.Namespace) -> dict:
    """A spawned rank of ``--mesh``: a failed run raises, so that the
    launcher stops the other ranks at once."""
    result = train(args)
    if result.get("status") != "success":
        raise RuntimeError(f"training failed: {result.get('error')}")
    return result


def main(argv=None) -> dict:
    """Run the command. ``--mesh DxM`` outside a process group spawns D
    ranks (gloo on the CPU, NCCL on the card) and returns rank 0's result,
    or a failed result naming the rank that failed; ``1xM`` with M > 1
    needs no group and trains in this process (``1x1`` spawns its one
    rank); a process already in a group is one rank of it."""
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.mesh:
        from ..core.mesh import spawn_ranks

        d, m = _mesh_shape(args.mesh)
        if (d > 1 or m == 1) and not torch.distributed.is_initialized():
            try:
                result = spawn_ranks(_rank_train, (args,), world_size=d,
                                     device=args.device)[0]
            except RuntimeError as e:
                result = {"status": "failed", "error": str(e)}
            print(json.dumps(
                {k: v for k, v in result.items() if k != "history"}))
            return result
    result = train(args)
    print(json.dumps({k: v for k, v in result.items() if k != "history"}))
    return result


if __name__ == "__main__":
    main()
