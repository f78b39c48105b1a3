"""Make ``verify_frames.npz``: the frame of
``examples/verify_checkpoints.py:make_clip`` and what the JAX package
reads on it with the trained checkpoints.

The frame is 640x640 BGR at 230 grey with ``HELLO``, ``WORLD`` and
``123`` in ``cv2.FONT_HERSHEY_SIMPLEX`` 2.0, thickness 3, at
(80, 160 + 160k). It is stored as BGR and as I420 (what the pipeline
ships with ``transfer_format="yuv420"``), so that a machine without cv2
can feed it to the port.

``vtd_tpu``'s ``VideoTextPipeline`` runs on the I420 frame (a batch of
two copies, ``max_dets=64``, its default dtypes) with
``demo_models2/dbnet/best_bf16`` and each engine:
``demo_models2/crnn/crnn_final`` (CRNN) and
``models/text_recognizer_trocr`` (TrOCR). For each engine the file keeps
the detections of the frame, in the pipeline's order: ``<engine>_boxes``
[N, 4] int, ``<engine>_texts`` [N] str, ``<engine>_det_conf`` and
``<engine>_rec_conf`` [N] float32.

    JAX_PLATFORMS=cpu python tests/torch_data/make_verify_frames.py
"""
from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "verify_frames.npz")
TRUTH = ["HELLO", "WORLD", "123"]
DETECTOR = "demo_models2/dbnet/best_bf16"
ENGINES = {
    "crnn": ("demo_models2/crnn/crnn_final", False),
    "trocr": ("models/text_recognizer_trocr", True),
}


def make_frame() -> np.ndarray:
    import cv2

    frame = np.full((640, 640, 3), 230, np.uint8)
    for k, word in enumerate(TRUTH):
        cv2.putText(frame, word, (80, 160 + 160 * k),
                    cv2.FONT_HERSHEY_SIMPLEX, 2.0, (0, 0, 0), 3)
    return frame


def reference_detections(frame_i420: np.ndarray, recognizer: str,
                         use_transformer: bool):
    from vtd_tpu.runtime import VideoTextPipeline

    pipe = VideoTextPipeline(
        detector_path=os.path.join(REPO, DETECTOR),
        recognizer_path=os.path.join(REPO, recognizer),
        use_transformer_ocr=use_transformer, batch_size=2, max_dets=64,
        transfer_format="yuv420",
    )
    frames = np.stack([frame_i420, frame_i420])
    per_frame = pipe.process_batch(frames, np.ones(2, bool))
    assert per_frame[0] == per_frame[1], "copies of one frame differ"
    return per_frame[0]


def main() -> None:
    import cv2

    sys.path.insert(0, REPO)
    frame = make_frame()
    i420 = cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420)
    out = {"frame_bgr": frame, "frame_i420": i420}
    for engine, (path, transformer) in ENGINES.items():
        dets = reference_detections(i420, path, transformer)
        texts = [d["text"] for d in dets]
        assert sorted(texts) == sorted(TRUTH), (engine, texts)
        out[f"{engine}_boxes"] = np.asarray([d["bbox"] for d in dets])
        out[f"{engine}_texts"] = np.asarray(texts)
        out[f"{engine}_det_conf"] = np.asarray(
            [d["detection_confidence"] for d in dets], np.float32)
        out[f"{engine}_rec_conf"] = np.asarray(
            [d["recognition_confidence"] for d in dets], np.float32)
        print(engine, list(zip(texts, out[f"{engine}_boxes"].tolist())))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
