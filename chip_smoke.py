#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vtd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:
  1. build every CUDA kernel from vtd_tpu_torch/csrc with nvcc (sm_90a);
     print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card,
     label for label, and time both per launch;
  3. drive the CRNN video path through ``VideoTextPipeline`` at full width
     (ResNet50-FPN DBNet at 640x640, CRNN with 2 BiLSTM layers of 256,
     seeded random weights) over a few pipelined batches, count kernel
     launches, check the results, and check the card's postprocess
     against the CPU's on the same probability maps;
  4. print one JSON line describing every kernel, then the device line.

Exits non-zero, printing no result, when CUDA is unavailable. Imports
nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

B, MAP = 16, 320  # main-path labelling shape: 16 frames, 640 map at stride 2
N_BATCHES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # non-tensor float32 peak, the table's nearest rate


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 30) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def banner(angle: float, length: int = 280, width: int = 6):
    """A thin filled rectangle through the map centre at ``angle``
    degrees, rasterised with numpy (no cv2 on the card machine)."""
    import numpy as np

    yy, xx = np.mgrid[0:MAP, 0:MAP].astype(np.float64)
    t = np.deg2rad(angle)
    u = (xx - MAP / 2) * np.cos(t) + (yy - MAP / 2) * np.sin(t)
    v = -(xx - MAP / 2) * np.sin(t) + (yy - MAP / 2) * np.cos(t)
    return (np.abs(u) <= length / 2) & (np.abs(v) <= width / 2)


def kernel_phase(torch, np, results):
    from vtd_tpu_torch.ops.cc_kernels import (
        segmented_cc_round, segmented_cc_round_plain,
    )
    from vtd_tpu_torch.ops.db_postprocess import connected_components

    rng = np.random.default_rng(0)
    cases = [(f"noise{p}", rng.random((B, MAP, MAP)) < p)
             for p in (0.3, 0.5, 0.7)]
    stairs = np.zeros((MAP, MAP), bool)
    for i in range(0, MAP - 2, 2):
        stairs[i:i + 2, i:i + 2] = True
    cases.append(("staircase", np.broadcast_to(stairs, (B, MAP, MAP))))
    cases.append(("banner-45", np.broadcast_to(banner(-45), (B, MAP, MAP))))
    cases.append(("banner30", np.broadcast_to(banner(30), (B, MAP, MAP))))
    cases.append(("empty", np.zeros((B, MAP, MAP), bool)))

    ident = np.arange(MAP * MAP, dtype=np.int32).reshape(1, MAP, MAP)
    perm = rng.permutation(MAP * MAP).astype(np.int32).reshape(1, MAP, MAP)
    max_diff = 0
    for name, m in cases:
        fg = torch.from_numpy(np.ascontiguousarray(m)).cuda()
        for lab in (ident, perm):
            lbl = torch.from_numpy(
                np.ascontiguousarray(np.broadcast_to(lab, (B, MAP, MAP)))
            ).cuda()
            for diag in (False, True):
                got = segmented_cc_round(fg, lbl, diag)
                want = segmented_cc_round_plain(fg, lbl, diag)
                torch.cuda.synchronize()
                diff = int((got != want).sum())
                max_diff = max(max_diff, int((got - want).abs().max()))
                if diff:
                    raise AssertionError(
                        f"segmented_cc_round differs from its plain version "
                        f"on {name} (diag={diag}): {diff} labels"
                    )
        # the whole production schedule (fast path + repair loop), card
        # kernel against the plain round on the CPU
        got = connected_components(fg).cpu()
        want = connected_components(fg.cpu())
        if not torch.equal(got, want):
            raise AssertionError(f"connected_components differs on {name}")
    print(f"kernel check: segmented_cc_round equals its plain version on "
          f"{len(cases)} map sets x 2 label seeds x diag False/True, and "
          f"the full labelling schedule matches; max label diff {max_diff}")

    fg = torch.from_numpy(cases[1][1]).cuda()
    lbl = torch.from_numpy(
        np.ascontiguousarray(np.broadcast_to(ident, (B, MAP, MAP)))
    ).cuda()
    times = {}
    for diag in (False, True):
        times[("plain", diag)] = time_ms(
            lambda: segmented_cc_round_plain(fg, lbl, diag))
        times[("kernel", diag)] = time_ms(
            lambda: segmented_cc_round(fg, lbl, diag))
        times[("plain2", diag)] = time_ms(
            lambda: segmented_cc_round_plain(fg, lbl, diag))
    # the fast path launches rounds with diag False, True, False
    kernel_ms = (2 * times[("kernel", False)] + times[("kernel", True)]) / 3
    plain_f = (times[("plain", False)] + times[("plain2", False)]) / 2
    plain_t = (times[("plain", True)] + times[("plain2", True)]) / 2
    plain_ms = (2 * plain_f + plain_t) / 3
    # one round reads the mask (1 B) and labels (4 B), writes labels (4 B)
    cells = B * MAP * MAP
    bound_bytes_ms = cells * 9 / HBM_BYTES_PER_S * 1e3
    # min operations: two 9-cell neighbourhood mins and one min per cell
    # for each line pass (rows, columns, and a third of the time both
    # diagonals)
    ops = cells * (2 * 9 + 2 + 2 / 3)
    bound_ops_ms = ops / FP32_OPS_PER_S * 1e3
    print(f"segmented_cc_round per launch [{B}x{MAP}x{MAP}]: kernel "
          f"diag=False {times[('kernel', False)]:.4f} ms, diag=True "
          f"{times[('kernel', True)]:.4f} ms; plain diag=False "
          f"{times[('plain', False)]:.4f}/{times[('plain2', False)]:.4f} ms, "
          f"diag=True {times[('plain', True)]:.4f}/"
          f"{times[('plain2', True)]:.4f} ms; bound "
          f"{max(bound_bytes_ms, bound_ops_ms) * 1e3:.2f} us")
    results["segmented_cc_round"] = {
        "name": "segmented_cc_round",
        "route": "cuda",
        "source": "vtd_tpu_torch/csrc/segmented_cc.cu",
        "replaces": "vtd_tpu/ops/pallas_kernels.py:173",
        "max_abs_err": max_diff,
        "max_label_diff": max_diff,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "kernel_us": kernel_ms * 1e3,
        "plain_us": plain_ms * 1e3,
        "kernel_us_diag": {str(d): times[("kernel", d)] * 1e3
                           for d in (False, True)},
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
    }


def make_batch(np, k: int):
    """16 I420 640x360 frames: dark bars on a light background."""
    h, w = 360, 640
    y = np.full((B, h, w), 220, np.uint8)
    for i in range(B):
        top = 40 + (7 * i + 13 * k) % 200
        y[i, top:top + 30, 60:420] = 25
        y[i, top + 70:top + 90, 200:560] = 40
    uv = np.full((B, h // 2, w), 128, np.uint8)
    return np.concatenate([y, uv], axis=1)


def stage_times(torch, pipe, frames, prob, card):
    """Median wall time of each stage of one batch, host clock around
    work that ends in a synchronise (the labelling waits on the device
    inside postprocess anyway)."""
    from vtd_tpu_torch.ops.crop import crop_and_resize_boxes_mm
    from vtd_tpu_torch.ops.ctc import ctc_greedy_decode_arrays
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess
    from vtd_tpu_torch.ops.preprocess import yuv420_to_bgr

    bgr = yuv420_to_bgr(frames)
    post = db_postprocess(prob, 0.5, max_dets=64, max_box_frac=1.0)
    budget = pipe._effective_rec_budget(B)

    def crop_recognize():
        crops = crop_and_resize_boxes_mm(bgr, post["boxes"], post["valid"])
        crops = crops.reshape(-1, 32, 128, 3)[:budget]
        return ctc_greedy_decode_arrays(pipe.recognizer.logits(crops))

    stages = {
        "yuv420_to_bgr": lambda: yuv420_to_bgr(frames),
        "preprocess+dbnet": lambda: pipe.detector.probability(frames),
        "db_postprocess": lambda: db_postprocess(
            prob, 0.5, max_dets=64, max_box_frac=1.0),
        "crop+crnn+ctc": crop_recognize,
        "whole batch": lambda: pipe._run_batch(
            frames, 0.5, torch.ones(B, dtype=torch.bool, device="cuda"),
            False),
    }
    out = []
    for name, fn in stages.items():
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        out.append(f"{name} {sorted(runs)[2]:.3f}")
    print(f"stage ms per {B}-frame batch (median of 5): " + ", ".join(out)
          + f" ({card})")


def pipeline_phase(torch, np, card, results):
    from vtd_tpu_torch.ops.cc_kernels import segmented_cc_round
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess
    from vtd_tpu_torch.runtime import VideoTextPipeline

    pipe = VideoTextPipeline(
        device="cuda", use_transformer_ocr=False, batch_size=B, max_dets=64,
        detector_input_size=640, transfer_format="yuv420", max_box_frac=1.0,
    )
    valid = np.ones(B, bool)
    batches = [make_batch(np, k) for k in range(N_BATCHES)]
    pipe.process_batch(batches[0], valid)  # warm-up: cuDNN plans, build
    torch.cuda.synchronize()

    segmented_cc_round.launches = 0
    t0 = time.perf_counter()
    handles = pipe.dispatch_batch(batches[0], valid_frames=valid)
    outs = []
    for k in range(N_BATCHES):
        nxt = (
            pipe.dispatch_batch(batches[k + 1], valid_frames=valid)
            if k + 1 < N_BATCHES else None
        )
        outs.append(pipe.process_batch(batches[k], valid, handles=handles))
        handles = nxt
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = segmented_cc_round.launches
    if launches < 3 * N_BATCHES:
        raise AssertionError(
            f"segmented_cc_round launched {launches} times over "
            f"{N_BATCHES} batches; the main path needs >= 3 per batch"
        )
    results["segmented_cc_round"]["launches"] = launches

    n_det = 0
    for per_frame in outs:
        if len(per_frame) != B:
            raise AssertionError("one result list per frame expected")
        for dets in per_frame:
            for d in dets:
                if set(d) != {"bbox", "text", "detection_confidence",
                              "recognition_confidence", "polygon"}:
                    raise AssertionError(f"malformed detection {d}")
                x1, y1, x2, y2 = d["bbox"]
                if not (0 <= x1 <= x2 <= 640 and 0 <= y1 <= y2 <= 360):
                    raise AssertionError(f"bbox out of frame {d['bbox']}")
                for c in ("detection_confidence", "recognition_confidence"):
                    if not 0.0 <= d[c] <= 1.0:
                        raise AssertionError(f"{c} out of range in {d}")
                if not isinstance(d["text"], str) or len(d["polygon"]) != 4:
                    raise AssertionError(f"malformed detection {d}")
                n_det += 1

    t1 = time.perf_counter()
    pipe.process_batch(batches[1], valid)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t1
    print(f"main path: {N_BATCHES} batches x {B} frames, {launches} kernel "
          f"launches, {n_det} detections")
    print(f"throughput {B * N_BATCHES / elapsed:.3f} frames/s pipelined, "
          f"single-batch latency {latency * 1e3:.3f} ms "
          f"(seeded weights, bf16, {card})")

    # the card's postprocess against the CPU's on the same maps: the
    # pipeline's own probability maps, and maps with known rectangles
    with torch.inference_mode():
        frames = torch.from_numpy(batches[0]).cuda()
        prob = pipe.detector.probability(frames)
        stage_times(torch, pipe, frames, prob, card)
        yy, xx = torch.meshgrid(torch.arange(640.0), torch.arange(640.0),
                                indexing="ij")
        synth = torch.zeros(B, 640, 640)
        for i in range(B):
            t = torch.tensor(np.deg2rad(-60 + 8 * i))
            u = (xx - 320) * torch.cos(t) + (yy - 300) * torch.sin(t)
            v = -(xx - 320) * torch.sin(t) + (yy - 300) * torch.cos(t)
            synth[i][(u.abs() <= 150 + 5 * i) & (v.abs() <= 12 + i)] = 0.9
            synth[i, 40:80, 60 + 10 * i:300] = 0.8
        for name, maps in (("pipeline", prob), ("synthetic", synth.cuda())):
            gpu = db_postprocess(maps, 0.5, max_dets=64, max_box_frac=1.0)
            cpu = db_postprocess(maps.cpu(), 0.5, max_dets=64,
                                 max_box_frac=1.0)
            if not torch.equal(gpu["valid"].cpu(), cpu["valid"]):
                raise AssertionError(f"valid masks differ on {name} maps")
            v = cpu["valid"]
            err = (gpu["boxes"].cpu()[v] - cpu["boxes"][v]).abs()
            err = float(err.max()) if err.numel() else 0.0
            if not err <= 0.5:
                raise AssertionError(f"boxes differ by {err} px on {name}")
            if not torch.isfinite(gpu["boxes"]).all():
                raise AssertionError("non-finite boxes")
            print(f"db_postprocess card vs CPU on {name} maps: "
                  f"{int(v.sum())} valid slots equal, boxes within {err} px")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np

    from vtd_tpu_torch._build import build_all

    card = card_line()
    t0 = time.perf_counter()
    logs = build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu\n{log.strip()}")
    print(card)

    results: dict = {}
    kernel_phase(torch, np, results)
    pipeline_phase(torch, np, card, results)

    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
