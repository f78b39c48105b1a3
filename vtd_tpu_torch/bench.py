"""Benchmark of the port: the five BASELINE.json configs on the card.

    python -m vtd_tpu_torch.bench [--config N] [--device-resident] [--all]
                                  [--device cuda|cpu]

The port of the repo's ``bench.py``, with its workloads, sizes, protocol,
metric names and JSON line:

  1  DBNet on single 640x640 frames: 50 serial detects (wall rate and
     latency), the upload alone, the I420 variant, and 100 back-to-back
     dispatches on a frame staged on the device (``device_fps``);
  2  the CRNN + greedy CTC over 512 synthesized text lines, 128 at a time;
  3  the CRNN video path (``_pipeline``: batch 16, 64 slots, 10 fps,
     ``host_downscale=640``, I420, the trained ``demo_models2``
     checkpoints) on a 24 s 720p clip after a 2 s warm-up, best of 5;
  3dr  (``--device-resident``) config 3's program on frames staged on the
     device first, ``dispatch_batch`` / ``process_batch`` kept
     ``pipeline_depth`` batches deep;
  4  a 24 s 1080p clip at ``target_fps=5``, ``sample_mode="keyframe"``,
     ``temporal_dedup`` over the results, best of 3;
  5  three 8 s streams through ``InferenceEngine``, best of 3.

Each config runs in its own process under ``VTD_BENCH_DEADLINE`` seconds
(default 1380) and prints one JSON line: ``metric``, ``value``, ``unit``,
``vs_baseline`` (against 10 frames/s, the reference's own estimate),
``vs_measured_ref`` where ``BASELINE_measured.json`` has the metric, the
config's extras, and, beside those, the device, the card's name and power
limit as ``nvidia-smi`` reads them, and the kernels' counts over the
config (wrapper calls of ``segmented_cc_round`` and the CUDA launches
they made, calls of ``neighbor_min_sweeps``). Device rates end with
``torch.cuda.synchronize()``. ``--all`` (or ``VTD_BENCH_CONFIGS``, e.g.
``3,3dr,5``) runs several configs, one line each. Every line is also
written to ``vtd_tpu_torch/.bench_out/<VTD_BENCH_TAG or latest>/``.

The run is on the card unless ``--device cpu`` is given. Without CUDA it
prints an ``"error": "cuda_unavailable"`` line for each config asked for
and exits 1; a config that fails, crashes or passes its deadline prints
its error line and the exit code is 1.

Config 2 reads with the trained CRNN where the repo has it (the
reference's config 2 draws random weights); the work is the same.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_FPS = 10.0  # the reference's optimistic GPU-worker estimate

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG)
_ARTIFACTS = os.path.join(_PKG, ".bench_out")
TRAINED_DETECTOR = os.path.join(_REPO, "demo_models2/dbnet/best_bf16")
TRAINED_CRNN = os.path.join(_REPO, "demo_models2/crnn/crnn_final")

CLIP_TEXTS = ["HELLO WORLD", "TPU NATIVE", "VIDEO OCR 123", "BENCHMARK"]


def clip_frames(seconds: int = 8, fps: int = 30):
    """The frames of :func:`make_clip` in order: 720p BGR uint8, a smooth
    gradient, a moving disc and four burned-in strings."""
    import cv2

    w, h = 1280, 720
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        80 + 60 * np.sin(xx / 200.0) + 50 * np.cos(yy / 150.0)
    ).astype(np.uint8)
    for i in range(seconds * fps):
        frame = np.stack([base, base + 20, base + 40], axis=-1)
        frame = np.clip(frame, 0, 255).astype(np.uint8)
        cx = 200 + int(150 * np.sin(i / 15.0))
        cv2.circle(frame, (cx, 500), 80, (60, 90, 160), -1)
        for k, t in enumerate(CLIP_TEXTS):
            cv2.putText(
                frame, t, (80 + 40 * k, 150 + 140 * k),
                cv2.FONT_HERSHEY_SIMPLEX, 2.2, (0, 0, 0), 5,
            )
        yield frame


def clip_1080p_frames(seconds: int = 24, fps: int = 30):
    """Config 4's frames: 1080p, a gradient and one persistent string."""
    import cv2

    w, h = 1920, 1080
    yy, xx = np.mgrid[0:h, 0:w]
    base = (90 + 50 * np.sin(xx / 300.0) + 40 * np.cos(yy / 200.0)).astype(
        np.uint8
    )
    for _ in range(seconds * fps):
        frame = np.stack([base, base + 15, base + 30], axis=-1).astype(
            np.uint8
        )
        cv2.putText(
            frame, "PERSISTENT TEXT", (300, 540),
            cv2.FONT_HERSHEY_SIMPLEX, 3.0, (0, 0, 0), 8,
        )
        yield frame


def write_clip(path: str, frames, fps: int) -> None:
    """Encode ``frames`` (BGR uint8, one size) as an mp4v file."""
    import cv2

    writer = None
    try:
        for frame in frames:
            if writer is None:
                h, w = frame.shape[:2]
                writer = cv2.VideoWriter(
                    path, cv2.VideoWriter_fourcc(*"mp4v"), float(fps), (w, h)
                )
            writer.write(frame)
    finally:
        if writer is not None:
            writer.release()


def make_clip(path: str, seconds: int = 8, fps: int = 30) -> None:
    """Synthetic but realistic 720p footage (noise frames would be an
    H.264 worst case that matches no real workload)."""
    write_clip(path, clip_frames(seconds, fps), fps)


# ----------------------------------------------------------------------
# the JSON line
# ----------------------------------------------------------------------
def _measured_ref(metric: str) -> float:
    """The reference pipeline's measured number for this metric
    (``BASELINE_measured.json``, from ``bench_reference.py``), or 0."""
    try:
        with open(os.path.join(_REPO, "BASELINE_measured.json")) as f:
            configs = json.load(f)["configs"]
    except (OSError, ValueError, KeyError):
        return 0.0
    remap = {  # metric name here -> bench_reference.py's
        "e2e_720p_ocr_frames_per_sec_per_chip": "e2e_720p_ocr_frames_per_sec",
        "e2e_1080p_keyframe_ocr_fps": "e2e_1080p_ocr_frames_per_sec",
        "dbnet_single_frame_detect_fps": "dbnet_single_frame_detect_fps",
    }
    want = remap.get(metric, metric)
    for cfg in configs.values():
        if cfg.get("metric") == want:
            return float(cfg.get("value", 0.0))
    return 0.0


def _emit(metric: str, value: float, unit: str, vs_baseline: float,
          json_extra: dict | None = None, **diag):
    out = {
        "metric": metric,
        "value": round(value, 2),
        "unit": unit,
        "vs_baseline": round(vs_baseline, 2),
    }
    if json_extra:
        out.update(json_extra)
    ref = _measured_ref(metric)
    if ref > 0:
        out["vs_measured_ref"] = round(value / ref, 2)
    print(json.dumps(out))
    sys.stdout.flush()
    _write_artifact(metric, out)
    if diag:
        print(" ".join(f"{k}={v}" for k, v in diag.items()), file=sys.stderr)


def _write_artifact(metric: str, out: dict) -> None:
    """Keep every emitted line under ``.bench_out/<VTD_BENCH_TAG>/``
    (ignored by git)."""
    d = os.path.join(_ARTIFACTS, os.environ.get("VTD_BENCH_TAG", "latest"))
    try:
        os.makedirs(d, exist_ok=True)
        rec = dict(out)
        rec["captured_unix"] = int(time.time())
        with open(os.path.join(d, f"{metric}.json"), "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
    except OSError as e:  # the line on stdout is the result
        print(f"bench: artifact not written: {e}", file=sys.stderr)


def _emit_failure(metric: str, error: str, detail: str = "") -> None:
    """One structured JSON line for a failed config."""
    out = {
        "metric": metric,
        "value": 0.0,
        "unit": "frames/s",
        "vs_baseline": 0.0,
        "error": error,
    }
    if detail:
        out["detail"] = detail[-800:]
    print(json.dumps(out))
    sys.stdout.flush()


def card_fields(device: str) -> dict:
    """The device, and the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them (None on the CPU)."""
    if device == "cpu":
        return {"device": "cpu", "card_name": None, "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (part.strip() for part in line.split(",", 1))
    return {"device": "cuda", "card_name": name, "power_limit": limit}


def reset_counts() -> None:
    from .ops.cc_kernels import neighbor_min_sweeps, segmented_cc_round

    for fn in (segmented_cc_round, neighbor_min_sweeps):
        fn.launches = 0
        fn.cuda_launches = 0


def kernel_counts() -> dict:
    """The kernels' counts since :func:`reset_counts`: wrapper calls that
    launched (``*_calls``) and the CUDA launches they made."""
    from .ops.cc_kernels import neighbor_min_sweeps, segmented_cc_round

    return {
        "segmented_cc_round_calls": segmented_cc_round.launches,
        "segmented_cc_round_cuda_launches": segmented_cc_round.cuda_launches,
        "neighbor_min_sweeps_calls": neighbor_min_sweeps.launches,
    }


def _line_extra(device: str) -> dict:
    return {**card_fields(device), **kernel_counts()}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _check(result: dict) -> dict:
    if result.get("status") != "success":
        raise RuntimeError(f"process_video failed: {result.get('error')}")
    return result


def _pipeline(device: str, **kw):
    from .runtime import VideoTextPipeline

    base = dict(
        use_transformer_ocr=False, batch_size=16, max_dets=64,
        target_fps=10.0, host_downscale=640, transfer_format="yuv420",
    )
    # the trained demo checkpoints give a stable, realistic detection
    # density; random weights swing from run to run
    if os.path.exists(TRAINED_DETECTOR):
        base["detector_path"] = TRAINED_DETECTOR
    if os.path.exists(TRAINED_CRNN):
        base["recognizer_path"] = TRAINED_CRNN
    base.update(kw)
    return VideoTextPipeline(device=device, **base)


# ----------------------------------------------------------------------
# the configs
# ----------------------------------------------------------------------
def bench_config1(device: str) -> None:
    """Config 1: DBNet detection on single 640x640 frames. ``value`` is
    the serial single-frame rate with the upload and the result's fetch
    in every call (``detect_batch``, which ``detect`` wraps without its
    catch-all); ``device_fps`` stages the frame on the device once and
    dispatches back to back."""
    import torch

    from .runtime.detector import TextDetector

    det = TextDetector(device=device)
    frame = np.random.default_rng(0).integers(
        0, 255, (640, 640, 3), np.uint8
    )
    det.detect_batch(frame[None])  # warm
    n = 50
    lat = np.empty(n)
    t0 = time.time()
    for i in range(n):
        t1 = time.time()
        det.detect_batch(frame[None])
        lat[i] = time.time() - t1
    fps = n / (time.time() - t0)
    lat_ms = np.sort(lat) * 1e3

    # the upload of the 1.2 MB frame alone
    up = np.empty(20)
    for i in range(20):
        t1 = time.time()
        torch.from_numpy(frame).to(device)
        _sync(device)
        up[i] = time.time() - t1
    upload_ms = float(np.median(up) * 1e3)

    # I420-packed upload (0.6 MB against 1.2 MB)
    det_y = TextDetector(transfer_format="yuv420", device=device)
    det_y.detect_batch(frame[None])
    t0 = time.time()
    for _ in range(n):
        det_y.detect_batch(frame[None])
    yuv_fps = n / (time.time() - t0)

    # the device's rate: the frame staged once, 100 dispatches, one sync
    staged = torch.from_numpy(frame[None]).to(device)
    det.detect_batch_arrays(staged, 0.5)
    _sync(device)
    m = 100
    t0 = time.time()
    for _ in range(m):
        det.detect_batch_arrays(staged, 0.5)
    _sync(device)
    device_fps = m / (time.time() - t0)
    _emit(
        "dbnet_single_frame_detect_fps", fps, "frames/s",
        fps / BASELINE_FPS,
        json_extra={
            "device_fps": round(device_fps, 2),
            "device_vs_baseline": round(device_fps / BASELINE_FPS, 2),
            "latency_ms_p50": round(float(lat_ms[n // 2]), 1),
            "latency_ms_p99": round(float(lat_ms[min(n - 1, int(n * 0.99))]), 1),
            "upload_ms_p50": round(upload_ms, 1),
            "yuv420_fps": round(yuv_fps, 2),
            "device_ms": round(1e3 / device_fps, 2),
            "note": "value: serial detect_batch of one frame, upload and "
                    "fetch included; device_fps stages the frame on the "
                    "device and dispatches back to back; upload_ms_p50 is "
                    "the upload alone",
            **_line_extra(device),
        },
    )


def config2_recognizer(device: str):
    """Config 2's recognizer: the CRNN (trained where the repo has it)."""
    from .runtime.recognizer import TextRecognizer

    path = TRAINED_CRNN if os.path.exists(TRAINED_CRNN) else None
    return TextRecognizer(path, use_transformer=False, pad_batch=128,
                          device=device)


def config2_crops(n: int = 512) -> list:
    """Config 2's inputs: ``n`` synthesized text lines (seed 0) as uint8
    BGR crops."""
    from .train.recognizer_trainer import synthesize_text_lines

    images, _ = synthesize_text_lines(n, seed=0)
    return [(images[i] * 255).astype(np.uint8) for i in range(len(images))]


def bench_config2(device: str) -> None:
    """Config 2: CRNN + CTC over pre-cropped text lines."""
    rec = config2_recognizer(device)
    crops = config2_crops(512)
    rec.recognize_batch(crops[:128])  # warm
    out = []
    t0 = time.time()
    for i in range(0, 512, 128):
        out = rec.recognize_batch(crops[i:i + 128])
    cps = 512 / (time.time() - t0)
    if not any(r["text"] for r in out):
        raise RuntimeError("config 2 read no text: recognition failed")
    # the reference reads crop by crop; its GPU estimate implies ~10
    # crops/s at ~1 crop a frame
    _emit("crnn_ctc_crops_per_sec", cps, "crops/s", cps / BASELINE_FPS,
          json_extra=_line_extra(device))


def _best_of(device: str, runs: int, fn) -> tuple:
    """``runs`` timed calls of ``fn`` (each closed with a sync) -> (the
    last result, every run's seconds)."""
    secs = []
    result = None
    for _ in range(runs):
        _sync(device)
        t0 = time.time()
        result = fn()
        _sync(device)
        secs.append(time.time() - t0)
    return result, secs


def bench_config3(device: str) -> None:
    """Config 3 (the headline): the 720p CRNN video path."""
    import asyncio

    with tempfile.TemporaryDirectory() as td:
        clip = os.path.join(td, "bench_720p.mp4")
        # 24 s -> 240 sampled frames: fill and drain are amortised
        make_clip(clip, seconds=24)
        pipeline = _pipeline(device)
        warm = os.path.join(td, "warm.mp4")
        make_clip(warm, seconds=2)
        _check(asyncio.run(pipeline.process_video(warm, td)))
        # best of 5: interference on the host only ever adds time
        result, runs = _best_of(device, 5, lambda: _check(
            asyncio.run(pipeline.process_video(clip, td))))
        elapsed = min(runs)
    frames = result["summary"]["total_frames"]
    _emit(
        "e2e_720p_ocr_frames_per_sec_per_chip",
        frames / elapsed, "frames/s",
        frames / elapsed / BASELINE_FPS,
        json_extra={"agg": "min_of_5",
                    "runs_fps": [round(frames / r, 1) for r in runs],
                    **_line_extra(device)},
        frames=frames, elapsed=f"{elapsed:.2f}s",
        detections=result["summary"]["total_detections"],
    )


def bench_config3_device_resident(device: str) -> None:
    """Config 3's program on frames staged on the device first: the
    upload leaves the loop, the per-batch host work (pack parse, text
    assembly) stays."""
    from collections import deque

    import torch

    with tempfile.TemporaryDirectory() as td:
        clip = os.path.join(td, "bench_720p.mp4")
        make_clip(clip)
        pipeline = _pipeline(device, transfer_format="bgr")
        info = pipeline.video_processor.get_video_info(clip)
        batches = list(
            pipeline.video_processor.extract_frame_batches(
                clip, batch_size=pipeline.batch_size, target_fps=10.0,
                resize_to=pipeline.ship_dims(info), pixel_format="bgr",
            )
        )
        staged = [torch.from_numpy(b["frames"]).to(device) for b in batches]
        _sync(device)
        warm = batches[0]
        pipeline.process_batch(
            warm["frames"], warm["valid"],
            handles=pipeline.dispatch_batch(staged[0]),
            orig_size=warm.get("orig_size"),
        )

        results = []
        pending: deque = deque()

        def _drain_one():
            h, bb = pending.popleft()
            results.extend(
                pipeline.process_batch(
                    bb["frames"], bb["valid"], handles=h,
                    orig_size=bb.get("orig_size"),
                )
            )

        _sync(device)
        t0 = time.time()
        for dev_frames, b in zip(staged, batches):
            pending.append((pipeline.dispatch_batch(dev_frames), b))
            if len(pending) > pipeline.pipeline_depth:
                _drain_one()
        while pending:
            _drain_one()
        _sync(device)
        elapsed = time.time() - t0
    frames = sum(int(b["valid"].sum()) for b in batches)
    dets = sum(len(r) for r in results)
    _emit(
        "e2e_720p_ocr_fps_device_resident",
        frames / elapsed, "frames/s",
        frames / elapsed / BASELINE_FPS,
        json_extra=_line_extra(device),
        frames=frames, elapsed=f"{elapsed:.2f}s", detections=dets,
    )


def bench_config4(device: str) -> None:
    """Config 4: 1080p with keyframe sampling and temporal text dedup."""
    import asyncio

    from .ops.nms import temporal_dedup

    with tempfile.TemporaryDirectory() as td:
        clip = os.path.join(td, "bench_1080p.mp4")
        write_clip(clip, clip_1080p_frames(24), 30)
        # only scene-change frames reach the device; near-duplicate
        # candidates inherit their keyframe's detections
        pipeline = _pipeline(device, target_fps=5.0, sample_mode="keyframe")
        warm = os.path.join(td, "warm.mp4")
        make_clip(warm, seconds=2)
        _check(asyncio.run(pipeline.process_video(warm, td)))
        # best of 3: the first pass pays the page cache of the 1080p file
        result, runs = _best_of(device, 3, lambda: _check(
            asyncio.run(pipeline.process_video(clip, td))))
        elapsed = min(runs)
        tracks = temporal_dedup(result["results"])
    frames = result["summary"]["total_frames"]
    keyframes = sum(1 for r in result["results"] if "duplicate_of" not in r)
    _emit(
        "e2e_1080p_keyframe_ocr_fps",
        frames / elapsed, "frames/s",
        frames / elapsed / BASELINE_FPS,
        json_extra={"agg": "min_of_3",
                    "runs_fps": [round(frames / r, 1) for r in runs],
                    **_line_extra(device)},
        frames=frames, keyframes=keyframes, tracks=len(tracks),
    )


def bench_config5(device: str) -> None:
    """Config 5: three concurrent streams through ``InferenceEngine``."""
    from .runtime.engine import InferenceEngine

    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i in range(3):
            p = os.path.join(td, f"s{i}.mp4")
            # 8 s a stream: the interleave reaches steady state
            make_clip(p, seconds=8)
            paths.append(p)
        engine = InferenceEngine(pipeline=_pipeline(device))
        try:
            warm = os.path.join(td, "warm.mp4")
            make_clip(warm, seconds=1)
            engine.process_videos([warm])
            results, runs = _best_of(
                device, 3, lambda: engine.process_videos(paths))
        finally:
            engine.close()
        elapsed = min(runs)
    for r in results.values():
        _check(r)
    total = sum(r["summary"]["total_frames"] for r in results.values())
    _emit(
        "multistream_aggregate_fps",
        total / elapsed, "frames/s",
        total / elapsed / BASELINE_FPS,
        json_extra={"agg": "min_of_3",
                    "runs_fps": [round(total / r, 1) for r in runs],
                    **_line_extra(device)},
        streams=len(paths), frames=total,
    )


_CONFIG_METRICS = {
    1: "dbnet_single_frame_detect_fps",
    2: "crnn_ctc_crops_per_sec",
    3: "e2e_720p_ocr_frames_per_sec_per_chip",
    4: "e2e_1080p_keyframe_ocr_fps",
    5: "multistream_aggregate_fps",
}

# --all order: the headline first
_ALL_SPECS = ["3", "3dr", "5", "4", "1", "2"]


def _metric_for(config: int, device_resident: bool) -> str:
    if device_resident and config == 3:
        return "e2e_720p_ocr_fps_device_resident"
    return _CONFIG_METRICS[config]


def _run_config(config: int, device_resident: bool, device: str) -> None:
    reset_counts()
    if device_resident and config == 3:
        return bench_config3_device_resident(device)
    {1: bench_config1, 2: bench_config2, 3: bench_config3,
     4: bench_config4, 5: bench_config5}[config](device)


def cuda_device_count(timeout: float = 120.0) -> int:
    """CUDA devices a fresh process sees, probed in a subprocess bounded
    by ``timeout`` (0 when the probe fails or hangs)."""
    code = ("import torch; print(torch.cuda.device_count() "
            "if torch.cuda.is_available() else 0)")
    try:
        res = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return 0
    try:
        return int(res.stdout.split()[-1])
    except (IndexError, ValueError):
        return 0


def _run_outer(config: int, device_resident: bool, device: str) -> bool:
    """One config in a deadline-bounded subprocess, its lines relayed.
    True when it printed its metric line without an error."""
    metric = _metric_for(config, device_resident)
    deadline = float(os.environ.get("VTD_BENCH_DEADLINE", "1380"))
    cmd = [sys.executable, "-m", "vtd_tpu_torch.bench", "--_inner",
           "--config", str(config), "--device", device]
    if device_resident:
        cmd.append("--device-resident")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=deadline, env=env)
    except subprocess.TimeoutExpired as e:
        tail = e.stderr or ""
        if isinstance(tail, bytes):
            tail = tail.decode(errors="replace")
        _emit_failure(metric, "bench_deadline_exceeded", tail)
        return False
    sys.stderr.write(proc.stderr)
    seen = ok = False
    for ln in proc.stdout.splitlines():
        if not ln.strip():
            continue
        print(ln)
        sys.stdout.flush()
        try:
            parsed = json.loads(ln)
        except ValueError:
            continue
        if isinstance(parsed, dict) and parsed.get("metric") == metric:
            seen, ok = True, "error" not in parsed
    if proc.returncode != 0 and not seen:
        _emit_failure(metric, "bench_crashed", proc.stderr[-800:])
    return ok and proc.returncode == 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--config", type=int, default=None, choices=[1, 2, 3, 4, 5],
        help="BASELINE.json benchmark config (default: 3, the headline)",
    )
    parser.add_argument(
        "--device-resident", action="store_true",
        help="config 3 with frames staged on the device first",
    )
    parser.add_argument(
        "--all", action="store_true",
        help="run every config and the device-resident variant, one JSON "
             "line each; equivalent to VTD_BENCH_CONFIGS="
             + ",".join(_ALL_SPECS),
    )
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the configs run (default: the card)",
    )
    parser.add_argument(
        "--_inner", action="store_true", help=argparse.SUPPRESS
    )
    args = parser.parse_args(argv)
    explicit_config = args.config is not None
    if args.config is None:
        args.config = 3

    if args._inner:
        _run_config(args.config, args.device_resident, args.device)
        return 0

    # an explicit --config is never overridden by the environment
    specs_env = "" if explicit_config else os.environ.get(
        "VTD_BENCH_CONFIGS", ""
    )
    if args.all or specs_env:
        names = ([s.strip() for s in specs_env.split(",") if s.strip()]
                 if specs_env and specs_env.lower() != "all"
                 else _ALL_SPECS)
        specs = []
        for name in names:
            dr = name.lower() in ("3dr", "dr")
            specs.append((3 if dr else int(name), dr))
    else:
        specs = [(args.config, args.device_resident)]

    if args.device == "cuda" and cuda_device_count() == 0:
        for cfg, dr in specs:
            _emit_failure(
                _metric_for(cfg, dr), "cuda_unavailable",
                "no CUDA device is visible; the bench runs on the card "
                "unless --device cpu is given",
            )
        return 1
    results = [_run_outer(cfg, dr, args.device) for cfg, dr in specs]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
