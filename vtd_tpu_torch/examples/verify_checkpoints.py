"""Re-verify the shipped demo checkpoints end to end (no training).

    python -m vtd_tpu_torch.examples.verify_checkpoints \
        [--detector demo_models2/dbnet/best_bf16] \
        [--crnn demo_models2/crnn/crnn_final] \
        [--trocr models/text_recognizer_trocr] [--device cuda|cpu]

Builds the port's pipeline from the checkpoints, runs it on a freshly
encoded 640x640 clip with HELLO, WORLD and 123 burned in, and requires
every string to be read exactly and nothing else to reach the summary:
through the CRNN path, and through the TrOCR path when its checkpoint
exists. Prints one JSON line per engine and ``VERIFY PASS``, or ``VERIFY
FAIL`` and exits 1. The fast regression gate for postprocess and
pipeline changes; ``train_and_verify`` does the same after training.
The default paths are the repo's checkpoints.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRUTH = ["HELLO", "WORLD", "123"]
FRAME = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "verify_frame.npz")


def verify_frame() -> np.ndarray:
    """The clip's frame, 640x640 BGR: the three strings in
    ``cv2.FONT_HERSHEY_SIMPLEX`` 2.0, thickness 3, black at (80, 160 +
    160k) on 230 grey, as OpenCV 5.0 draws them (the frame the JAX
    package reads as HELLO / WORLD / 123). It is stored, not drawn:
    OpenCV 4.13 draws the same call with thinner strokes (6610 dark
    pixels against 9979), which the trained checkpoints read as VORLD and
    l23 in both packages."""
    with np.load(FRAME) as z:
        return z["frame_bgr"]


def clip_frames():
    """The verify clip's 60 frames, each the frame of :func:`verify_frame`."""
    frame = verify_frame()
    for _ in range(60):
        yield frame


def make_clip(path: str) -> None:
    from ..bench import write_clip

    write_clip(path, clip_frames(), 30)


def run_clip(detector: str, recognizer: str, use_transformer: bool,
             device: str = "cuda", **pipeline_kw) -> dict:
    """``process_video`` of the verify clip on a pipeline built from the
    checkpoints (confidence 0.5, batch 8) -> its result dict."""
    from ..runtime.pipeline import VideoTextPipeline

    with tempfile.TemporaryDirectory() as td:
        clip = os.path.join(td, "verify.mp4")
        make_clip(clip)
        pipeline = VideoTextPipeline(
            detector_path=detector,
            recognizer_path=recognizer,
            use_transformer_ocr=use_transformer,
            confidence_threshold=0.5,
            batch_size=8,
            device=device,
            **pipeline_kw,
        )
        result = asyncio.run(pipeline.process_video(clip, td))
    if result["status"] != "success":
        raise RuntimeError(f"process_video failed: {result.get('error')}")
    return result


def verify(detector: str, recognizer: str, use_transformer: bool,
           device: str = "cuda") -> dict:
    s = run_clip(detector, recognizer, use_transformer, device)["summary"]
    detected = set(s["detected_texts"])
    return {
        "engine": "transformer" if use_transformer else "crnn",
        "frames": s["total_frames"],
        "detections": s["total_detections"],
        "detected_texts": sorted(detected)[:10],
        "exact_matches": sum(1 for t in TRUTH if t in detected),
        # equality, not containment: junk tracks (a frame-border box)
        # must not reach the summary
        "clean": detected == set(TRUTH),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--detector",
                    default=os.path.join(_REPO, "demo_models2/dbnet/best_bf16"))
    ap.add_argument("--crnn",
                    default=os.path.join(_REPO, "demo_models2/crnn/crnn_final"))
    ap.add_argument("--trocr",
                    default=os.path.join(_REPO, "models/text_recognizer_trocr"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    ok = True
    r = verify(args.detector, args.crnn, False, args.device)
    print(json.dumps(r), flush=True)
    ok &= r["exact_matches"] == len(TRUTH) and r["clean"]
    if args.trocr and os.path.exists(args.trocr):
        r = verify(args.detector, args.trocr, True, args.device)
        print(json.dumps(r), flush=True)
        ok &= r["exact_matches"] == len(TRUTH) and r["clean"]
    print("VERIFY", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
