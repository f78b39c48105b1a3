"""Device time and wall time of each stage of the CRNN pipeline.

    python -m vtd_tpu_torch.tools.profile_device [--batch 8] [--iters 10] \
        [--detector demo_models2/dbnet/best_bf16] \
        [--recognizer demo_models2/crnn/crnn_final] [--device cuda|cpu]

Stages, run in this order on ``--batch`` seeded 640x640 frames staged on
the device:
    pre        uint8 -> normalised frames (ops/preprocess)
    fwd        DBNet probability branch (models/dbnet)
    post_cc    db_postprocess through the connected components
    post_topk  + component areas and the top-K selection
    post_bnd   + the boundary cells of each component
    post_full  the whole db_postprocess (calipers and scores included)
    crop       crop and resize of all K slots
    crnn       CRNN + greedy CTC over all B*K crops
    fused      the pipeline's own per-batch program (``dispatch_batch``
               and the pack's copy to the host)

The incremental cost of a postprocess phase is the difference between
consecutive post_* rows (each re-runs the phases before it).

Device time: every stage runs under ``torch.profiler.record_function(
"STAGE_<name>")`` in one pass, and the CUDA kernels it launched (its
children's included) are summed from the trace. Where the profiler sees
no device time, each stage is timed with CUDA events instead: that is
the span on the device from the stage's start to its end, idle gaps
included. The printout says which was used. Wall time: a second pass
without the profiler, the card synchronised before and after each
stage. ``idle`` is ``1 - device / wall``: the share of the stage's wall
time in which the card ran none of its kernels, that is, waited on the
host. The two come from two passes, and kernels on several streams
overlap in the sum, so a stage that keeps the card busy can read a
little below 0. On the CPU there is no device time ("not measured").

The defaults are the repo's trained checkpoints; a path that does not
exist raises (the reference falls back to random weights).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DETECTOR = os.path.join(_REPO, "demo_models2/dbnet/best_bf16")
RECOGNIZER = os.path.join(_REPO, "demo_models2/crnn/crnn_final")
STAGES = ("pre", "fwd", "post_cc", "post_topk", "post_bnd", "post_full",
          "crop", "crnn", "fused")
MAX_DETS = 64


def run_stages(pipe, frames, thresh: float, around) -> dict:
    """One pass over the stages, each called as ``around(name, fn)`` ->
    every stage's output."""
    from ..ops.crop import crop_and_resize_boxes_mm
    from ..ops.ctc import ctc_greedy_decode_arrays
    from ..ops.db_postprocess import db_postprocess
    from ..ops.preprocess import preprocess_frames
    from ..runtime.pipeline import collect

    det, rec = pipe.detector, pipe.recognizer
    b = frames.shape[0]
    out = {}

    def post(stage):
        return lambda: db_postprocess(out["fwd"], thresh, max_dets=MAX_DETS,
                                      stage=stage)

    out["pre"] = around("pre", lambda: preprocess_frames(
        frames, out_size=det.input_size))
    out["fwd"] = around("fwd", lambda: det.model.probability(
        out["pre"].permute(0, 3, 1, 2)))
    for name, stage in (("post_cc", "cc"), ("post_topk", "topk"),
                        ("post_bnd", "boundary"), ("post_full", "full")):
        out[name] = around(name, post(stage))
    po = out["post_full"]
    out["crop"] = around("crop", lambda: crop_and_resize_boxes_mm(
        frames, po["boxes"], po["valid"], out_h=32, out_w=128))
    out["crnn"] = around("crnn", lambda: ctc_greedy_decode_arrays(
        rec.logits(out["crop"].reshape(b * MAX_DETS, 32, 128, 3))))
    out["fused"] = around("fused", lambda: collect(
        pipe.dispatch_batch(frames))[0])
    return out


def _profiled_device_ms(pipe, frames, thresh, iters) -> dict:
    """{stage: device ms a pass} summed from the profiler's kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def around(name, fn):
        with record_function("STAGE_" + name):
            return fn()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run_stages(pipe, frames, thresh, around)
        torch.cuda.synchronize()
    us = dict.fromkeys(STAGES, 0.0)
    for ev in prof.events():
        if (ev.name.startswith("STAGE_") and ev.device_type == DeviceType.CPU
                and ev.name[len("STAGE_"):] in us):
            us[ev.name[len("STAGE_"):]] += ev.device_time_total
    return {k: v / iters / 1e3 for k, v in us.items()}


def profile_stages(batch: int = 8, iters: int = 10,
                   detector: str = DETECTOR, recognizer: str = RECOGNIZER,
                   device: str = "cuda") -> dict:
    """Build the pipeline, warm every stage, then time ``iters`` passes
    -> {"stages": {name: {device_ms, wall_ms, idle}}, "timing": how the
    device time was read, "counts": the kernels' counts over the wall
    passes, "frames": the input, "outputs": the last pass's outputs}."""
    import torch

    from ..bench import _sync, kernel_counts
    from ..runtime.pipeline import VideoTextPipeline

    for path in (detector, recognizer):
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
    pipe = VideoTextPipeline(
        use_transformer_ocr=False, batch_size=batch, max_dets=MAX_DETS,
        detector_path=detector, recognizer_path=recognizer,
        transfer_format="bgr", device=device,
    )
    dev = pipe.device
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 255, (batch, 640, 640, 3), np.uint8)).to(dev)
    thresh = 0.5
    with torch.inference_mode():
        run_stages(pipe, frames, thresh, lambda name, fn: fn())  # warm
        _sync(dev)

        wall = dict.fromkeys(STAGES, 0.0)
        events = {k: [] for k in STAGES}

        def timed(name, fn):
            _sync(dev)
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            res = fn()
            if dev.type == "cuda":
                end.record()
                events[name].append((start, end))
            _sync(dev)
            wall[name] += (time.perf_counter() - t0) * 1e3 / iters
            return res

        before = kernel_counts()
        for _ in range(iters):
            outputs = run_stages(pipe, frames, thresh, timed)
        counts = {k: v - before[k] for k, v in kernel_counts().items()}

        device_ms = dict.fromkeys(STAGES)
        timing = "not measured (CPU)"
        if dev.type == "cuda":
            device_ms = _profiled_device_ms(pipe, frames, thresh, iters)
            timing = "torch.profiler, CUDA kernels summed"
            if not any(device_ms.values()):
                device_ms = {k: sum(s.elapsed_time(e) for s, e in v) / iters
                             for k, v in events.items()}
                timing = ("CUDA events around each stage (the profiler saw "
                          "no device time; spans include idle gaps)")
    pipe.close()
    stages = {
        k: {"device_ms": device_ms[k], "wall_ms": wall[k],
            "idle": (None if device_ms[k] is None or wall[k] <= 0
                     else 1.0 - device_ms[k] / wall[k])}
        for k in STAGES
    }
    return {"stages": stages, "timing": timing, "counts": counts,
            "frames": frames, "outputs": outputs}


def report(res: dict, batch: int, iters: int, card: str) -> str:
    lines = [f"# ms per {batch}-frame batch ({iters} iters; {card}); device "
             f"time: {res['timing']}",
             f"{'stage':10} {'device ms':>10} {'wall ms':>10} {'idle':>6}"]
    for k, s in res["stages"].items():
        dev = ("not measured" if s["device_ms"] is None
               else f"{s['device_ms']:.3f}")
        idle = "" if s["idle"] is None else f"{s['idle']:.3f}"
        note = "  (production single-dispatch)" if k == "fused" else ""
        lines.append(f"{k:10} {dev:>10} {s['wall_ms']:10.3f} {idle:>6}{note}")
    c = res["counts"]
    lines.append(
        f"segmented_cc_round {c['segmented_cc_round_calls']} calls "
        f"({c['segmented_cc_round_cuda_launches']} CUDA launches), "
        f"neighbor_min_sweeps {c['neighbor_min_sweeps_calls']} calls over "
        f"the {iters} wall passes")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--detector", default=DETECTOR)
    ap.add_argument("--recognizer", default=RECOGNIZER)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from ..bench import card_fields

    res = profile_stages(args.batch, args.iters, args.detector,
                         args.recognizer, args.device)
    c = card_fields(args.device)
    card = ("CPU" if args.device == "cpu"
            else f"{c['card_name']}, {c['power_limit']}")
    print(report(res, args.batch, args.iters, card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
