"""Score a training run's TrOCR candidates and promote the best past the
incumbent.

    python -m vtd_tpu_torch.tools.r5_promote TRAIN_DIR \
        [--incumbent-score 22] [--promote] [--dest D] [--device cuda|cpu]

The candidates are ``trocr_final``, ``trocr_autosave_a`` and
``trocr_autosave_b`` in TRAIN_DIR, each an orbax directory (what the JAX
package's trainer writes) or a ``.pt`` file (what the port's trainer
writes). Each is scored in this process by ``eval_trocr_ckpt.evaluate``
on the held-out random-8 protocol with ``TRAIN_DIR/trocr_final_config.json``;
a table line gives its score, its character accuracy and which crops
were scored. With ``--promote`` the best one is copied to ``--dest`` when
it beats ``--incumbent-score`` (default 22, the round-4 champion): a
directory as the directory ``D``, a ``.pt`` file as ``D.pt``, and the
config as ``D_config.json``, which ``TransformerRecognizer(model_path=...)``
loads. The default ``--dest`` lies under ``vtd_tpu_torch/.report_out/``
(ignored by git); ``--dest models/text_recognizer_trocr`` replaces the
repo's TrOCR.

Exit codes: 1 when no candidate is found or none could be scored, 3 when
``--promote`` is given and the best does not beat the incumbent, else 0.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys

from .eval_trocr_ckpt import evaluate
from .update_report import OUT_DIR

CANDIDATES = ("trocr_final", "trocr_autosave_a", "trocr_autosave_b")


def candidates(train_dir: str) -> list:
    """The candidates found in ``train_dir``, in the order of
    :data:`CANDIDATES`, a directory before a ``.pt`` file of one name."""
    found = []
    for name in CANDIDATES:
        path = os.path.join(train_dir, name)
        if os.path.isdir(path):
            found.append(path)
        if os.path.isfile(path + ".pt"):
            found.append(path + ".pt")
    return found


def promote(best: str, cfg: str, dest: str) -> str:
    """Copy ``best`` and its config to ``dest``; returns the copy's path."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    if os.path.isdir(best):
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(best, dest)
        target = dest
    else:
        target = dest + ".pt"
        shutil.copy(best, target)
    shutil.copy(cfg, dest + "_config.json")
    return target


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("train_dir")
    parser.add_argument("--incumbent-score", type=int, default=22)
    parser.add_argument("--promote", action="store_true")
    parser.add_argument("--dest",
                        default=os.path.join(OUT_DIR, "text_recognizer_trocr"),
                        help="where --promote copies the best candidate")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    cfg = os.path.join(args.train_dir, "trocr_final_config.json")
    found = candidates(args.train_dir)
    if not found:
        print("no checkpoints found in", args.train_dir)
        return 1
    results = []
    for ckpt in found:
        try:
            r = evaluate(ckpt, cfg, args.device)
        except Exception as e:  # noqa: BLE001
            print(f"{ckpt}: eval failed: {e}")
            continue
        n = int(r["heldout_exact_match_random8"].split("/")[0])
        results.append((n, r["heldout_char_accuracy_random8"], ckpt))
        print(f"{ckpt}: {r['heldout_exact_match_random8']} "
              f"(char {r['heldout_char_accuracy_random8']:.4f}; "
              f"crops {r['crops']})")
    if not results:
        return 1
    results.sort(reverse=True)
    best_n, best_char, best = results[0]
    print(f"\nbest: {best} at {best_n}/32 "
          f"(incumbent {args.incumbent_score}/32)")
    if not args.promote:
        return 0
    if best_n <= args.incumbent_score:
        print("no improvement; keeping incumbent")
        return 3
    print(f"promoted {best} -> {promote(best, cfg, args.dest)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
