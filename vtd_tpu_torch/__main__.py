"""vtd_tpu_torch command-line interface (port of ``vtd_tpu/__main__.py``).

  python -m vtd_tpu_torch process <video> [--crnn] [--threshold 0.5] [--out r.json]
  python -m vtd_tpu_torch serve [--host H] [--port P] [--device cuda|cpu]
  python -m vtd_tpu_torch train-detector ...    (see train/train_detector.py)
  python -m vtd_tpu_torch train-recognizer ...  (see train/train_recognizer.py)
  python -m vtd_tpu_torch train-trocr ...       (see train/trocr_trainer.py)

Every command runs on the card (``--device cuda``, the default) unless
``--device cpu`` is given. ``worker`` and ``brokerd`` are not ported yet
(ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

BROKER_NOT_PORTED = (
    "{} is not ported yet: it waits for the next slice of the port "
    "(ROADMAP queue 1 item 9: the broker, brokerd and the process pool); "
    "`python -m vtd_tpu_torch serve` runs the in-process thread worker"
)
MULTI_GPU_NOT_PORTED = (
    "--data-parallel and --two-stage wait for ROADMAP queue 1 item 7 "
    "(multiple GPUs)"
)


def _cmd_process(argv):
    parser = argparse.ArgumentParser(prog="vtd_tpu_torch process")
    parser.add_argument("video")
    parser.add_argument("--crnn", action="store_true",
                        help="use CRNN recognizer instead of transformer")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--min-rec-confidence", type=float, default=0.0,
                        help="drop transcripts with OCR confidence below "
                             "this (0.0 never filters)")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--fps", type=float, default=10.0)
    parser.add_argument("--detector", default="", help="detector checkpoint")
    parser.add_argument("--recognizer", default="", help="recognizer checkpoint")
    parser.add_argument("--input-size", type=int, default=640,
                        help="detector input resolution")
    parser.add_argument("--sample-mode", default="stride",
                        choices=["stride", "keyframe"],
                        help="keyframe ships only scene-change frames")
    parser.add_argument("--temporal-dedup", action="store_true",
                        help="cross-frame text tracks in the summary")
    parser.add_argument("--max-dets", type=int, default=64,
                        help="per-frame detection slot count")
    parser.add_argument("--out", default="", help="write JSON result here")
    parser.add_argument("--format", default="json",
                        choices=["json", "csv", "xml"])
    parser.add_argument("--data-parallel", type=int, default=0, metavar="N",
                        help="not ported (multiple GPUs)")
    parser.add_argument("--two-stage", action="store_true",
                        help="not ported (multiple GPUs)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.data_parallel or args.two_stage:
        print(MULTI_GPU_NOT_PORTED, file=sys.stderr)
        return 2

    from .runtime.pipeline import VideoTextPipeline

    pipeline = VideoTextPipeline(
        detector_path=args.detector or None,
        recognizer_path=args.recognizer or None,
        use_transformer_ocr=not args.crnn,
        confidence_threshold=args.threshold,
        min_recognition_confidence=args.min_rec_confidence,
        batch_size=args.batch_size,
        target_fps=args.fps,
        detector_input_size=args.input_size,
        sample_mode=args.sample_mode,
        temporal_dedup=args.temporal_dedup,
        max_dets=args.max_dets,
        device=args.device,
    )
    result = asyncio.run(pipeline.process_video(args.video, "."))
    if args.format == "json":
        payload = json.dumps(result, indent=2, default=str)
    else:
        from .serve.services.processing_service import ProcessingService

        svc = ProcessingService()
        if args.format == "csv":
            payload = asyncio.run(svc.export_results_csv(result))
        else:
            payload = asyncio.run(svc.export_results_xml(result))
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        print(f"wrote {args.out}")
    else:
        print(payload)
    return 0 if result.get("status") == "success" else 1


def _cmd_train_trocr(argv):
    parser = argparse.ArgumentParser(prog="vtd_tpu_torch train-trocr")
    parser.add_argument("--samples", type=int, default=8192)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=6e-4)
    parser.add_argument("--weight-decay", type=float, default=1e-4)
    parser.add_argument("--image-size", type=int, default=48,
                        help="crop height fed to the encoder")
    parser.add_argument("--image-width", type=int, default=192,
                        help="crop width (text-shaped rectangle; "
                        "0 = square like HF ViT)")
    parser.add_argument(
        "--no-augment", action="store_true",
        help="disable on-device photometric augmentation",
    )
    parser.add_argument(
        "--fresh-data", action="store_true",
        help="draw a fresh --samples-sized training set every epoch "
        "(rendered on a prefetch thread) instead of reusing one fixed set",
    )
    parser.add_argument("--enc-dim", type=int, default=0,
                        help="override encoder/decoder width (0 = demo "
                        "default 128)")
    parser.add_argument("--layers", type=int, default=0,
                        help="override encoder/decoder depth (0 = demo "
                        "default 4)")
    parser.add_argument("--checkpoint-dir", default="./models")
    parser.add_argument("--init-from", default="",
                        help="continue training from this checkpoint's "
                        "weights (fresh optimizer; pick a lower --lr "
                        "than the original run)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from .train.trocr_trainer import (
        TrOCRTrainer,
        demo_config,
        synthesize_trocr_crops,
    )

    dims = {}
    if args.enc_dim:
        dims.update(
            enc_dim=args.enc_dim, dec_dim=args.enc_dim,
            enc_mlp=2 * args.enc_dim, dec_mlp=2 * args.enc_dim,
        )
    if args.layers:
        dims.update(enc_layers=args.layers, dec_layers=args.layers)
    cfg = demo_config(
        image_size=args.image_size, image_width=args.image_width, **dims
    )
    images, texts = synthesize_trocr_crops(args.samples, cfg, seed=0)
    val_images, val_texts = synthesize_trocr_crops(512, cfg, seed=999)
    trainer = TrOCRTrainer(
        {
            "checkpoint_dir": args.checkpoint_dir,
            "max_epochs": args.epochs,
            "batch_size": args.batch_size,
            "learning_rate": args.lr,
            "weight_decay": args.weight_decay,
            "augment": not args.no_augment,
            "init_from": args.init_from or None,
        },
        model_config=cfg,
        device=args.device,
    )
    data_fn = None
    if args.fresh_data:
        # disjoint seed block per epoch (held-out sets use 999 / 424242)
        def data_fn(epoch):
            return synthesize_trocr_crops(args.samples, cfg,
                                          seed=100_000 + epoch)
    out = trainer.train(images, texts, val_images, val_texts,
                        data_fn=data_fn)
    if out.get("status") == "success":
        # the hardest held-out slice: random 8-character strings from a
        # disjoint seed, read back from the saved checkpoint
        from .runtime.trocr_runtime import TransformerRecognizer

        h_img, h_txt = synthesize_trocr_crops(
            32, cfg, seed=424242, length_range=(8, 9)
        )
        model = TransformerRecognizer(
            model_path=out["best_model_path"], device=args.device
        ).model
        ev = trainer.evaluate(model, h_img, h_txt)
        out["heldout_exact_match_random8"] = "%d/32" % round(
            ev["val_exact_match"] * 32
        )
        out["heldout_char_accuracy_random8"] = ev["val_char_accuracy"]
    print(json.dumps({k: v for k, v in out.items() if k != "history"}))
    return 0 if out.get("status") == "success" else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "process":
        return _cmd_process(rest)
    if cmd == "serve":
        from .serve.app import main as serve_main

        return serve_main(rest)
    if cmd in ("worker", "brokerd"):
        print(BROKER_NOT_PORTED.format(cmd), file=sys.stderr)
        return 2
    if cmd.startswith("train"):
        # per-epoch progress lines of the trainers' loggers
        import logging

        logging.basicConfig(
            level=logging.WARNING,
            format="%(asctime)s %(name)s: %(message)s",
        )
        logging.getLogger("vtd_tpu_torch").setLevel(logging.INFO)
    if cmd == "train-trocr":
        return _cmd_train_trocr(rest)
    if cmd == "train-detector":
        from .train.train_detector import main as td_main

        td_main(rest)
        return 0
    if cmd == "train-recognizer":
        from .train.train_recognizer import main as tr_main

        tr_main(rest)
        return 0
    print(f"unknown command {cmd!r}\n{__doc__}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
