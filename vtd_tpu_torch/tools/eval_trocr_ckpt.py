"""Score a TrOCR checkpoint on the demo's held-out slice.

    python -m vtd_tpu_torch.tools.eval_trocr_ckpt CKPT [--config JSON] \
        [--device cuda|cpu]

The protocol of the ``train-trocr`` command's final report: 32 random
strings of 8 characters drawn at seed 424242 (disjoint from training),
greedy decode, exact match counted. That is the number kept as
``heldout_exact_match_random8`` in ``demo_models2/report.json``. CKPT is
an orbax directory of the JAX package or a port ``.pt`` file; the
architecture comes from the sidecar (default
``<dir of CKPT>/trocr_final_config.json``). Prints one JSON line.

The crops of the demo's 48x192 input are stored beside this file
(``heldout_random8.npz``, uint8, as OpenCV 5.0 renders them; the JAX
package's ``synthesize_trocr_crops`` gives the same bytes there): OpenCV
4.13 renders the same strings otherwise, and both packages read its
crops at 0/32. Other input sizes are rendered on the spot. ``crops`` in
the line says which.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

N_HELDOUT = 32
HELDOUT_SEED = 424242
STORED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "heldout_random8.npz")


def heldout(cfg):
    """(crops normalised as ``synthesize_trocr_crops`` makes them, their
    strings, where the crops come from)."""
    from ..train.trocr_trainer import synthesize_trocr_crops

    with np.load(STORED) as z:
        crops, texts = z["crops"], [str(t) for t in z["texts"]]
    if crops.shape[1:3] == (cfg.image_size, cfg.width):
        images = crops.astype(np.float32) / 255.0
        return (images - 0.5) / 0.5, texts, "stored"
    import cv2

    images, texts = synthesize_trocr_crops(
        N_HELDOUT, cfg, seed=HELDOUT_SEED, length_range=(8, 9)
    )
    return images, texts, f"rendered with OpenCV {cv2.__version__}"


def evaluate(ckpt: str, config: str = "", device: str = "cuda") -> dict:
    from ..train.trocr_trainer import TrOCRTrainer, load_config

    cfg_path = config or os.path.join(
        os.path.dirname(ckpt.rstrip("/")), "trocr_final_config.json"
    )
    cfg = load_config(cfg_path)
    trainer = TrOCRTrainer({"init_from": ckpt}, model_config=cfg,
                           device=device)
    model = trainer.build_model()
    h_img, h_txt, source = heldout(cfg)
    ev = trainer.evaluate(model, h_img, h_txt)
    return {
        "ckpt": ckpt,
        "heldout_exact_match_random8": "%d/%d" % (
            round(ev["val_exact_match"] * N_HELDOUT), N_HELDOUT),
        "heldout_char_accuracy_random8": ev["val_char_accuracy"],
        "crops": source,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("ckpt", help="orbax checkpoint dir or port .pt file")
    parser.add_argument("--config", default="",
                        help="sidecar config json (default: "
                             "<ckpt_dir>/trocr_final_config.json)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    print(json.dumps(evaluate(args.ckpt, args.config, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
