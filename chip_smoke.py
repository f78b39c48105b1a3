#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vtd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Every CUDA kernel of vtd_tpu_torch/csrc is built first with nvcc (sm_90a,
one compiler process per source, all at once) and the card's name and
power limit are printed. Then the phases, each of which fails the run on
any error:
  segmented  hold ``segmented_cc_round`` against its plain PyTorch
             version on the card, label for label, at the main path's
             shape and on every edge of its launch plan (batch of one,
             partial strips, lines shorter than a warp, 1xN, Nx1, the
             tallest map the plan takes), check the whole labelling
             schedule against the CPU, then time the kernel on the device
             (a CUDA graph of rounds), the wrapper on the host, and the
             plain version; then the reference's single-map rank: a 2-D
             [320, 320] call equal to row 0 of the batched call and to
             the plain version, counted (1 call = 2 CUDA launches, 4 with
             diag), its host time beside a [1, 320, 320] call's;
  sweeps     the same for ``neighbor_min_sweeps`` (iters 1/4/8/65 on
             noise, staircase, banners, empty, full, border, B=1, maps
             that are no multiple of the tile, 1x1, 1x300, 300x1, 7x1000,
             a halo past the map; an empty batch), then its time per call
             in a loop of calls (``ms``), its device time (a CUDA graph of
             calls), its host time per call and the plain version's; the
             same single-map check as ``segmented`` (1 call =
             ``sweep_plan(320, 320, 8).launches`` CUDA launches);
  dense      the dense labelling path, ``connected_components(
             backend="pallas")``, on the card against the CPU, with its
             4 wrapper calls and CUDA launches counted, its time per call
             and its device time (a CUDA graph of calls);
  crnn       drive the CRNN video path through ``VideoTextPipeline`` at
             full width (ResNet50-FPN DBNet at 640x640, CRNN with 2 BiLSTM
             layers of 256, seeded random weights) over a few pipelined
             batches, count kernel launches, check the results, and check
             the card's postprocess against the CPU's on the same maps;
  trocr      drive the TrOCR engine through ``VideoTextPipeline`` at full
             width (default TrOCRConfig: 384x384, encoder 768x12, decoder
             1024x12, 50 steps, bf16), check the model's numerics, count
             crops recognised and kernel launches (``decode_attention``:
             2 x 12 layers x 50 steps a chunk), print stage times; time
             ``decode_attention`` at the decoder's shapes beside its bound,
             its plain version and ``F.scaled_dot_product_attention`` (a
             yardstick only), and a 16-crop chunk's graphed kernels with
             the kernel and with the plain attention captured instead;
  trained    restore the repo's trained checkpoints (``models/``) with the
             port's own OCDBT reader, run the CRNN path at config 3's
             settings (batch 16, 64 slots, ``host_downscale=640``, I420,
             bf16) on 16 copies of the frame shipped in
             ``tests/torch_data/verify_frames.npz``, require the JAX
             package's stored transcripts (HELLO, WORLD, 123) and boxes,
             print the stage line with this real detection load and the
             kernel launches; the same for the trained TrOCR;
  engine     ``InferenceEngine`` on the trained CRNN pipeline: three
             streams through ``submit_batch`` (the shipped frame and
             ``make_batch`` frames) and one frame by frame through
             ``submit_frame``; every Future equals ``process_batch`` on
             the same frames; aggregate frames/s and batches dispatched;
  beam       build the C++ CTC prefix beam with g++, build it again with
             ``build(force=True)`` (the seconds g++ takes; a fresh process
             decodes with the rebuilt library as the plain beam does) and
             call ``native.video.build(force=True)``, which raises where
             libav is absent, as on the card's machine; hold it against the
             plain Python beam on the trained CRNN's log-probs of the
             ``trained`` batch and on seeded random log-probs (sequences
             equal, scores within 1e-4), and time it;
  serve      the port's REST service: its ``Server`` on 127.0.0.1 in a
             thread (thread worker, in-memory SQLite, the trained
             checkpoints of ``models/``, ``device="cuda"``), driven over
             HTTP with urllib: register, log in, upload a 640x640 mp4v clip
             of the shipped frame with a scene change halfway, detect with
             the CRNN, with TrOCR and with ``sample_mode=keyframe`` (two
             jobs back to back, each equal to its solo run), poll, read the
             results and the CSV / XML / annotated exports; every frame
             must read HELLO, WORLD, 123, ``segmented_cc_round`` must be
             launched inside the jobs, ``/health/detailed`` must name the
             card through the CUDA probe and ``/metrics`` count the
             pipeline's batches; the same clip straight through
             ``process_video`` for comparison; then ``python -m
             vtd_tpu_torch serve`` as a process until ``/health/ready``
             answers;
  fleet      the serving fleet: ``python -m vtd_tpu_torch brokerd --port
             0`` and one ``python -m vtd_tpu_torch worker --broker
             tcp://...`` as processes on the card behind the port's
             ``Server`` (its own queue drains nothing), a CRNN, a TrOCR
             and a warm CRNN job posted with ``APIClient``; then the same
             ``Server`` on the process pool (concurrency 2,
             ``max_tasks_per_child=2``): two jobs at once in two children,
             a job on a long clip cancelled mid-run (its child SIGKILLed),
             a respawned child completing a job, a recycle; every job reads
             HELLO / WORLD / 123 and ``segmented_cc_round`` is counted in
             the process that ran the job (this file's
             ``PROCESS_VIDEO_TASK``, which the worker takes through
             ``worker_main``), ``neighbor_min_sweeps`` too; the first job
             waits in the queue before the worker starts; no process left
             running;
             then one ``process_video`` with ``profile_dir``, whose trace
             must name the labelling kernels and a cuDNN convolution, its
             results equal to the runs without it;
  train      the port's training at full width: the DBNet step (640x640,
             batch 8, float32), the CRNN step (batch 32, CTC on the card),
             the TrOCR demo step (batch 32) and the default TrOCRConfig's
             step (batch 16, bf16 compute, float32 weights), each timed
             with CUDA events with its loss falling (finite for the last),
             its peak memory, its FLOPs counted from the shapes and a
             profiler line; ``ModelTrainer`` (2 epochs at 160x160) and
             ``RecognizerTrainer`` (1 epoch) with their checkpoints read
             by ``TextDetector`` / ``TextRecognizer``, the demo TrOCR saved
             and read back by ``TransformerRecognizer``; one DBNet and one
             CRNN step from the trained checkpoints on the card against
             the CPU (loss and gradient norm within the stated
             tolerances);
  parallel   several devices, the trained checkpoints at config 3's
             settings on the shipped frame: the fused pipeline, a mesh of
             ``[cuda:0]`` and one of two replicas on ``[cuda:0, cuda:0]``
             (two threads, two streams) over the same pipelined batches,
             each equal to the fused path, with their frames/s and their
             ``segmented_cc_round`` calls counted; the two-stage runner
             (both stages on the card) through ``run_batches`` against the
             fused path, and one TrOCR batch through it; ``train-detector
             --mesh 1x1`` (one spawned NCCL rank) and its checkpoint; the
             data-parallel DBNet step (640x640, global batch 8, float32)
             with one NCCL rank and with two gloo ranks on the card, each
             against the one-process step (loss and gradient norm within
             the stated tolerances), ms/step and the gradient all-reduce's
             ms; with two or more cards also a mesh, the two-stage
             pipeline and NCCL ranks over distinct cards. No rank is left;
  hostapi    the rest of the reference's host API: a DBNet ``.pth`` in the
             original app's layout (``tests/torch_app_layout.py``, seeded,
             full widths) loaded by ``TextDetector`` on the card, its
             backbone and head bit-equal to ``dbnet_from_app_state``, its
             map against the same file on the CPU; ``save_model`` then
             ``load_model`` of the trained detector under a name with no
             ``.pt`` suffix (bit-equal), with the ms of ``load_model`` for
             an orbax directory, the app ``.pth`` and the port's file;
             ``extract_single_frame`` on the serve clip into
             ``process_single_frame`` on the trained CRNN pipeline (HELLO /
             WORLD / 123, both kernels counted); ``db_postprocess`` and
             ``crop_and_resize_boxes_mm`` on one trained map (one image)
             against row 0 of the batched call, the kernels counted on the
             one-map call; ``VideoResult`` rebuilt
             from a ``process_video`` result; ``start_metrics_server``
             serving the port's registry;
  tp         the mesh's model axis, on the trained checkpoints at config
             3's settings: the CRNN pipeline on a 1x2 mesh ``[cuda:0,
             cuda:0]`` and on a 2x2 mesh of four ``cuda:0`` entries (each
             row's DBNet and CRNN split over its two entries: 38 and 13
             split tensors), each over the same pipelined batches as the
             fused path and equal to it (HELLO / WORLD / 123, boxes at IoU
             >= 0.95), frames/s beside the fused path,
             ``segmented_cc_round`` counted on each row's lead; the
             default TrOCRConfig (seeded, bf16, 195 split tensors) on a
             1x2 row against the unsplit recogniser on one 16-crop chunk
             (tokens equal, encoder output within TP_ENC_RTOL); one DBNet
             step (640x640, batch 8, float32) on a 1x2 row against the
             one-process step within the data-parallel step's tolerances
             and ms/step of both with TF32 convolutions; ``train-detector
             --mesh 1x2`` in this process and its checkpoint read by an
             unsplit ``TextDetector``; with two or more cards also the
             pipeline and the DBNet step on a row over two cards, with
             four ``train-detector --mesh 2x2`` as two NCCL ranks, each
             on a row of two cards;
  decode     the native libav decoder: whether the machine has libav (the
             decoder's ``g++ -E`` header probe beside ``pkg-config
             --modversion libavcodec libswscale``, which must agree);
             with libav, build it, hold native against cv2 on the serve
             clip (640x640 I420, stride and keyframe: frame numbers,
             timestamps, valid, orig_size and dups equal, pixels within a
             mean absolute difference of 6.0 a batch) and run the trained
             CRNN pipeline's ``process_video`` at native and at cv2
             (frames/s, host ms per decoded batch, ``segmented_cc_round``
             counted on the native path); without libav, show that
             ``available()`` is False, ``decode_backend="native"`` raises
             ``ValueError`` and 'auto' gives cv2's batches byte for byte,
             and count the kernel on ``process_video`` at 'auto';
  bench      ``python -m vtd_tpu_torch.bench --all`` in a subprocess, as a
             user runs it: the five BASELINE.json
             configs and the device-resident config 3, one JSON line
             each, every line with its metric name, a value above 0, no
             error, the card's name and power limit and the kernels'
             counts in that config;
  profile    ``vtd_tpu_torch.tools.profile_device`` at batch 16 with the
             trained checkpoints: device ms (kernels summed from
             ``torch.profiler``), wall ms and idle share of each of its
             nine stages, the kernels counted over its wall passes;
  examples   ``vtd_tpu_torch.examples.verify_checkpoints`` (must print
             ``VERIFY PASS``: HELLO / WORLD / 123 and nothing else on the
             CRNN and the TrOCR path), ``train_and_verify --quick`` (its
             report printed) and ``tools.eval_trocr_ckpt`` on
             ``demo_models2/trocr_r5/trocr_final`` (must read 32/32, as
             ``demo_models2/report.json`` records), each in this process
             with the kernels counted around it;
  report     ``vtd_tpu_torch.tools.update_report`` into a temporary
             ``--out`` (``e2e`` and ``e2e_transformer`` must equal
             ``demo_models2/report.json``'s key for key, ``avg_det_conf``
             within 0.001, every other section untouched), then
             ``tools.r5_promote demo_models2/trocr_r5`` (``trocr_final``
             at 32/32), with ``--promote --dest`` into a temporary
             directory (rc 0; the copy loads and reads 32/32 again) and
             with ``--incumbent-score 32`` (rc 3, nothing copied), the
             kernels counted around each tool.
Each phase prints its time, and the script its whole time. Last come one
JSON line describing every kernel and the device line.
``--phases a,b`` runs a subset while working on one phase. ``--baseline
DIR`` times another checkout's ``neighbor_min_sweeps`` (for example the
parent commit unpacked with ``git archive``) beside this one's, in turns,
in the sweeps and dense phases, and both wrappers' host time per batched
call beside this one's in the single-map checks.

Exits non-zero, printing no result, when CUDA is unavailable. Imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import io
import json
import subprocess
import sys
import time

B, MAP = 16, 320  # main-path labelling shape: 16 frames, 640 map at stride 2
N_BATCHES = 4  # CRNN path
N_TROCR_BATCHES = 3  # each may carry up to 64 chunks of 50 decode steps
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


def record_launches(results, kernel: str, key: str, count: int) -> None:
    """A kernel's launch count on one path, into its entry of the kernels
    line (``launches`` is the count on the kernel's own main path). The
    counts are of wrapper calls that launched; ``cuda_launches`` counts
    the CUDA launches they made where one call makes several."""
    results.setdefault(kernel, {"name": kernel})[key] = count


def map_cases(np, rng, with_extremes: bool = False):
    """Named [B, MAP, MAP] bool map sets the kernels are checked on."""
    cases = [(f"noise{p}", rng.random((B, MAP, MAP)) < p)
             for p in (0.3, 0.5, 0.7)]
    stairs = np.zeros((MAP, MAP), bool)
    for i in range(0, MAP - 2, 2):
        stairs[i:i + 2, i:i + 2] = True
    cases.append(("staircase", np.broadcast_to(stairs, (B, MAP, MAP))))
    cases.append(("banner-45", np.broadcast_to(banner(-45), (B, MAP, MAP))))
    cases.append(("banner30", np.broadcast_to(banner(30), (B, MAP, MAP))))
    cases.append(("empty", np.zeros((B, MAP, MAP), bool)))
    if with_extremes:
        cases.append(("full", np.ones((B, MAP, MAP), bool)))
        frame = np.zeros((MAP, MAP), bool)
        frame[0, :] = frame[-1, :] = frame[:, 0] = frame[:, -1] = True
        frame[:, MAP // 2] = True  # one component touching every border
        cases.append(("border", np.broadcast_to(frame, (B, MAP, MAP))))
    return cases


def graph_us(torch, fn, rounds: int = 30, reps: int = 10) -> float:
    """Device time of one call of ``fn`` in microseconds: a CUDA graph of
    ``rounds`` calls replayed ``reps`` times between CUDA events, so the
    host's launch cost is out of the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds) * 1e3


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one call of ``fn`` in microseconds (enqueue only; the
    device drains the queue after the clock stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def tall_height(plan_of, w: int) -> int:
    """The largest H whose [H, w] map the kernel's launch plan takes."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            plan_of(mid, w)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


def one_map_check(torch, np, results, kernel, plain, arg, cuda_per_call,
                  card, baseline=None):
    """The reference's single-map rank on the card: a 2-D [MAP, MAP] call
    of ``kernel`` equals row 0 of the [B, MAP, MAP] call and the plain
    version on the same map, label for label; it is one wrapper call of
    ``cuda_per_call`` CUDA launches; its host time per call beside a
    [1, MAP, MAP] call's, in turns (2-D, batch of one, batch of one,
    2-D). With ``baseline`` (another checkout's package) that checkout's
    wrapper is timed beside this one's on the [1, MAP, MAP] and
    [B, MAP, MAP] batches, in turns (this, baseline, baseline, this)."""
    name = kernel.__name__
    rng = np.random.default_rng(16)
    maps = torch.from_numpy(rng.random((B, MAP, MAP)) < 0.5).cuda()
    lbl = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        rng.permutation(MAP * MAP).astype(np.int32).reshape(1, MAP, MAP),
        (B, MAP, MAP)))).cuda()
    batch = kernel(maps, lbl, arg)
    before = kernel.launches, kernel.cuda_launches
    one = kernel(maps[0], lbl[0], arg)
    calls = kernel.launches - before[0]
    cuda = kernel.cuda_launches - before[1]
    want = plain(maps[0], lbl[0], arg)
    torch.cuda.synchronize()
    if one.shape != (MAP, MAP) or one.dtype != torch.int32:
        raise AssertionError(f"{name} on one map gave {one.shape} {one.dtype}")
    for other, what in ((batch[0], "row 0 of the batched call"),
                        (want, "its plain version")):
        diff = int((one != other).sum())
        if diff:
            raise AssertionError(
                f"{name}({arg}) on one map differs from {what}: {diff} labels")
    if (calls, cuda) != (1, cuda_per_call):
        raise AssertionError(
            f"{name} on one map: {calls} wrapper calls = {cuda} CUDA "
            f"launches, expected 1 = {cuda_per_call}")
    fg1, lbl1 = maps[:1], lbl[:1]
    fg2, lbl2 = maps[0], lbl[0]
    reads = {"2d": [], "b1": []}
    for who in ("2d", "b1", "b1", "2d"):
        fg, lb = (fg2, lbl2) if who == "2d" else (fg1, lbl1)
        reads[who].append(host_us(torch, lambda: kernel(fg, lb, arg)))
    us = {k: sum(v) / len(v) for k, v in reads.items()}
    if baseline is not None:
        old = getattr(importlib.import_module("vtd_baseline.ops.cc_kernels"),
                      name)
        for size, (fg, lb) in (("1", (fg1, lbl1)), (str(B), (maps, lbl))):
            pair = {"this": [], "baseline": []}
            for who in ("this", "baseline", "baseline", "this"):
                fn = kernel if who == "this" else old
                pair[who].append(host_us(torch, lambda: fn(fg, lb, arg)))
            print(f"baseline {baseline}: {name}({arg}) host time per "
                  f"[{size}x{MAP}x{MAP}] call, this tree "
                  f"{'/'.join(f'{x:.3f}' for x in pair['this'])} us, the "
                  f"baseline {'/'.join(f'{x:.3f}' for x in pair['baseline'])}"
                  f" us ({card})")
            us[f"this_b{size}"] = sum(pair["this"]) / 2
            us[f"baseline_b{size}"] = sum(pair["baseline"]) / 2
    print(f"one map: {name}({arg}) on [{MAP}x{MAP}] equals row 0 of the "
          f"[{B}x{MAP}x{MAP}] call and its plain version label for label, "
          f"1 wrapper call = {cuda} CUDA launches; host time per call 2-D "
          f"{'/'.join(f'{x:.3f}' for x in reads['2d'])} us, [1x{MAP}x{MAP}] "
          f"{'/'.join(f'{x:.3f}' for x in reads['b1'])} us, so the rank "
          f"handling costs {us['2d'] - us['b1']:.3f} us a call ({card})")
    results[name].setdefault("one_map", {})[str(arg)] = {
        "calls": calls, "cuda_launches": cuda, "host_us_2d": us.pop("2d"),
        "host_us_batch_of_one": us.pop("b1"), **us}


def segmented_phase(torch, np, results, card, baseline=None):
    """segmented_cc_round against its plain version on the card, label for
    label, on the main path's shape and on every edge of the launch plan
    (batch of one, partial strips, short and single-cell lines, the
    tallest map the plan takes); the whole labelling schedule against the
    CPU; then device time, host time per call and the plain version's."""
    from vtd_tpu_torch.ops.cc_kernels import (
        segmented_cc_round, segmented_cc_round_plain, segmented_plan,
    )
    from vtd_tpu_torch.ops.db_postprocess import connected_components

    rng = np.random.default_rng(0)
    cases = map_cases(np, rng, with_extremes=True)
    big = cases[:]  # [B, MAP, MAP]: the schedule is checked on these too

    def noise(b, h, w, p=0.5):
        return rng.random((b, h, w)) < p

    cases.append(("B=1", noise(1, MAP, MAP)))
    odd = noise(5, 50, 70)
    odd[3] = True
    odd[4] = False
    odd[4, 0, :] = odd[4, -1, :] = odd[4, :, 0] = odd[4, :, -1] = True
    cases.append(("50x70", odd))
    p = segmented_plan(333, 251)
    cases.append((f"333x251 (strips {p.rows}/{p.cols}/{p.diags})",
                  noise(3, 333, 251, 0.6)))
    cases.append(("40x13 (W<32)", noise(4, 40, 13, 0.6)))
    cases.append(("13x40 (H<32)", noise(4, 13, 40, 0.6)))
    line = noise(4, 1, 300, 0.7)
    line[3] = True
    cases.append(("1x300", line))
    cases.append(("300x1", line.transpose(0, 2, 1).copy()))
    cases.append(("1x1", np.array([[[True]], [[False]]])))
    tall = tall_height(segmented_plan, 64)
    cases.append((f"{tall}x64 (tallest)", noise(1, tall, 64, 0.6)))

    max_diff = 0
    n_checks = 0
    for name, m in cases:
        fg = torch.from_numpy(np.ascontiguousarray(m)).cuda()
        b, h, w = fg.shape
        ident = np.arange(h * w, dtype=np.int32).reshape(1, h, w)
        perm = rng.permutation(h * w).astype(np.int32).reshape(1, h, w)
        for lab in (ident, perm):
            lbl = torch.from_numpy(
                np.ascontiguousarray(np.broadcast_to(lab, (b, h, w)))
            ).cuda()
            for diag in (False, True):
                got = segmented_cc_round(fg, lbl, diag)
                want = segmented_cc_round_plain(fg, lbl, diag)
                torch.cuda.synchronize()
                diff = int((got != want).sum())
                max_diff = max(max_diff, int((got - want).abs().max()))
                n_checks += 1
                if diff:
                    raise AssertionError(
                        f"segmented_cc_round differs from its plain version "
                        f"on {name} (diag={diag}): {diff} labels"
                    )
    for name, m in big:
        # the whole production schedule (fast path + repair loop), card
        # kernel against the plain round on the CPU
        fg = torch.from_numpy(np.ascontiguousarray(m)).cuda()
        got = connected_components(fg).cpu()
        want = connected_components(fg.cpu())
        if not torch.equal(got, want):
            raise AssertionError(f"connected_components differs on {name}")
    print(f"kernel check: segmented_cc_round equals its plain version on "
          f"{len(cases)} map sets ({', '.join(n for n, _ in cases)}) x 2 "
          f"label seeds x diag False/True ({n_checks} comparisons), and the "
          f"full labelling schedule matches on the {len(big)} [{B},{MAP},"
          f"{MAP}] sets; max label diff {max_diff}")

    fg = torch.from_numpy(cases[1][1]).cuda()
    lbl = torch.arange(MAP * MAP, dtype=torch.int32, device="cuda").reshape(
        1, MAP, MAP).expand(B, MAP, MAP).contiguous()
    times = {}
    for diag in (False, True):
        def kern(diag=diag):
            return segmented_cc_round(fg, lbl, diag)

        times[("plain", diag)] = time_ms(
            lambda: segmented_cc_round_plain(fg, lbl, diag))
        times[("kernel", diag)] = time_ms(kern)
        times[("device", diag)] = graph_us(torch, kern)
        times[("host", diag)] = host_us(torch, kern)
        times[("device2", diag)] = graph_us(torch, kern)
        times[("plain2", diag)] = time_ms(
            lambda: segmented_cc_round_plain(fg, lbl, diag))
    # the fast path launches rounds with diag False, True, False
    def mix(f, t):
        return (2 * f + t) / 3

    dev = {d: (times[("device", d)] + times[("device2", d)]) / 2
           for d in (False, True)}
    device_us = mix(dev[False], dev[True])
    kernel_ms = mix(times[("kernel", False)], times[("kernel", True)])
    plain_f = (times[("plain", False)] + times[("plain2", False)]) / 2
    plain_t = (times[("plain", True)] + times[("plain2", True)]) / 2
    plain_ms = mix(plain_f, plain_t)
    # one round reads the mask (1 B) and labels (4 B), writes labels (4 B)
    cells = B * MAP * MAP
    bound_bytes_ms = cells * 9 / HBM_BYTES_PER_S * 1e3
    # min operations: two 9-cell neighbourhood mins and one min per cell
    # for each line pass (rows, columns, and a third of the time both
    # diagonals)
    ops = cells * (2 * 9 + 2 + 2 / 3)
    bound_ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"segmented_cc_round per round [{B}x{MAP}x{MAP}], device time "
          f"(CUDA graph of 30 rounds): diag=False "
          f"{times[('device', False)]:.3f}/{times[('device2', False)]:.3f} us "
          f"(2 launches), diag=True {times[('device', True)]:.3f}/"
          f"{times[('device2', True)]:.3f} us (4 launches), F/T/F mix "
          f"{device_us:.3f} us; host time per wrapper call diag=False "
          f"{times[('host', False)]:.3f} us, diag=True "
          f"{times[('host', True)]:.3f} us; events around a loop of wrapper "
          f"calls diag=False {times[('kernel', False)] * 1e3:.3f} us, "
          f"diag=True {times[('kernel', True)] * 1e3:.3f} us; plain "
          f"diag=False {times[('plain', False)]:.4f}/"
          f"{times[('plain2', False)]:.4f} ms, diag=True "
          f"{times[('plain', True)]:.4f}/{times[('plain2', True)]:.4f} ms; "
          f"bound {bound_ms * 1e3:.2f} us")
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
        "kernel_device_us": device_us,
        "kernel_device_us_diag": {str(d): dev[d] for d in (False, True)},
        "host_us_per_call": {str(d): times[("host", d)]
                             for d in (False, True)},
        "cuda_launches_per_round": {"False": 2, "True": 4},
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
    }
    for diag in (False, True):
        one_map_check(torch, np, results, segmented_cc_round,
                      segmented_cc_round_plain, diag, 4 if diag else 2, card,
                      baseline)


def load_baseline(path: str):
    """The ``vtd_tpu_torch`` package of another checkout (for example the
    parent commit unpacked with ``git archive``), imported as
    ``vtd_baseline`` beside this one; it builds its own kernels from its
    own sources into its own ``.build``."""
    import importlib.util
    from pathlib import Path

    init = Path(path).resolve() / "vtd_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "vtd_baseline", init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["vtd_baseline"] = module
    spec.loader.exec_module(module)
    return module


def sweeps_times(torch, ops, fg, lbl, iters):
    """One reading of a sweeps kernel at the main shape: ``ms`` per wrapper
    call in a loop of calls between CUDA events, device µs per call (CUDA
    graph of 30 calls) and host µs per call."""
    def kern():
        return ops.neighbor_min_sweeps(fg, lbl, iters)

    return {"ms": time_ms(kern, reps=100), "device_us": graph_us(torch, kern),
            "host_us": host_us(torch, kern)}


def sweeps_phase(torch, np, results, card, baseline=None):
    """neighbor_min_sweeps against its plain version on the card, label
    for label, on the main path's shape and on every edge of its launch
    plan (batch of one, partial tiles, 1x1, 1xN, Nx1, a halo past the map,
    iters split over several launches); then its times at the dense
    path's shape: a loop of wrapper calls (``ms``), device time (CUDA
    graph) and host time per call, and the plain version's. With
    ``baseline`` (another checkout's package) that checkout's kernel is
    timed beside this one's, in turns."""
    from vtd_tpu_torch.ops import cc_kernels
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, neighbor_min_sweeps_plain, sweep_plan,
    )

    rng = np.random.default_rng(1)
    cases = map_cases(np, rng, with_extremes=True)

    def noise(b, h, w, p=0.6):
        return rng.random((b, h, w)) < p

    cases.append(("B=1", noise(1, MAP, MAP, 0.5)))
    # a size that is no multiple of the kernel's tile
    odd = rng.random((5, 50, 70)) < 0.5
    odd[3] = True
    odd[4] = False
    odd[4, 0, :] = odd[4, -1, :] = odd[4, :, 0] = odd[4, :, -1] = True
    cases.append(("50x70", odd))
    p = sweep_plan(161, 83, 8)
    cases.append((f"161x83 (tile {p.tile}, {p.grid_rows}x{p.grid_cols} "
                   f"tiles)", noise(3, 161, 83)))
    line = noise(4, 1, 300, 0.7)
    line[3] = True
    cases.append(("1x300", line))
    cases.append(("300x1", line.transpose(0, 2, 1).copy()))
    cases.append(("1x1", np.array([[[True]], [[False]]])))
    cases.append(("7x1000", noise(2, 7, 1000)))
    cases.append(("5x9 (halo past the map)", noise(2, 5, 9, 0.8)))
    iter_set = (1, 4, 8, 65)
    max_diff = 0
    n_checks = 0
    for name, m in cases:
        fg = torch.from_numpy(np.ascontiguousarray(m)).cuda()
        b, h, w = fg.shape
        ident = np.broadcast_to(
            np.arange(h * w, dtype=np.int32).reshape(1, h, w), (b, h, w))
        perm = np.broadcast_to(
            rng.permutation(h * w).astype(np.int32).reshape(1, h, w),
            (b, h, w))
        for lab in (ident, perm):
            lbl = torch.from_numpy(np.ascontiguousarray(lab)).cuda()
            for iters in iter_set:
                before = neighbor_min_sweeps.cuda_launches
                got = neighbor_min_sweeps(fg, lbl, iters)
                launched = neighbor_min_sweeps.cuda_launches - before
                want = neighbor_min_sweeps_plain(fg, lbl, iters)
                torch.cuda.synchronize()
                diff = int((got != want).sum())
                max_diff = max(max_diff, int((got - want).abs().max()))
                n_checks += 1
                if diff:
                    raise AssertionError(
                        f"neighbor_min_sweeps differs from its plain version "
                        f"on {name} (iters={iters}): {diff} labels"
                    )
                if launched != sweep_plan(h, w, iters).launches:
                    raise AssertionError(
                        f"{launched} CUDA launches for iters={iters}")
    empty = torch.zeros((0, MAP, MAP), dtype=torch.bool, device="cuda")
    if neighbor_min_sweeps(empty, empty.int(), 8).shape != empty.shape:
        raise AssertionError("empty batch malformed")
    print(f"kernel check: neighbor_min_sweeps equals its plain version on "
          f"{len(cases)} map sets ({', '.join(n for n, _ in cases)}) x 2 "
          f"label seeds x iters {'/'.join(map(str, iter_set))} "
          f"({n_checks} comparisons, iters 65 in "
          f"{sweep_plan(MAP, MAP, 65).launches} CUDA launches); an empty "
          f"batch returns empty; max label diff {max_diff}")

    iters = 8
    fg = torch.from_numpy(cases[1][1]).cuda()
    lbl = torch.arange(MAP * MAP, dtype=torch.int32, device="cuda").reshape(
        1, MAP, MAP).expand(B, MAP, MAP).contiguous()
    base = None if baseline is None else importlib.import_module(
        "vtd_baseline.ops.cc_kernels")
    plain1 = time_ms(lambda: neighbor_min_sweeps_plain(fg, lbl, iters))
    order = ["new", "new"] if base is None else ["base", "new", "new", "base"]
    reads = {"new": [], "base": []}
    for who in order:
        reads[who].append(sweeps_times(
            torch, cc_kernels if who == "new" else base, fg, lbl, iters))
    plain2 = time_ms(lambda: neighbor_min_sweeps_plain(fg, lbl, iters))
    mean = {k: sum(r[k] for r in reads["new"]) / len(reads["new"])
            for k in reads["new"][0]}
    # one sweep on the same grid of blocks: what loading and storing the
    # windows (and the launch) cost, the rest being the sweeps
    plan = sweep_plan(MAP, MAP, iters)
    one = sweep_plan(MAP, MAP, 1)
    if (one.grid_rows, one.grid_cols) != (plan.grid_rows, plan.grid_cols):
        raise AssertionError(f"iters=1 plan {one} has another grid")
    one_us = graph_us(torch, lambda: neighbor_min_sweeps(fg, lbl, 1))
    plain_ms = (plain1 + plain2) / 2
    # the function reads the mask (1 B) and labels (4 B) and writes labels
    # (4 B) once per cell whatever iters is; 9 mins per cell per sweep
    cells = B * MAP * MAP
    bound_bytes_ms = cells * 9 / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = cells * 9 * iters / FP32_OPS_PER_S * 1e3

    def show(r):
        return ("/".join(f"{x['device_us']:.3f}" for x in r) + " us device, "
                + "/".join(f"{x['host_us']:.3f}" for x in r) + " us host, "
                + "/".join(f"{x['ms'] * 1e3:.3f}" for x in r)
                + " us per call in a loop of calls")

    print(f"neighbor_min_sweeps per wrapper call [{B}x{MAP}x{MAP}], "
          f"iters={iters} ({plan.launches} CUDA launch, {plan.tile}x"
          f"{plan.tile} tiles, halo {plan.halo}, "
          f"{plan.grid_rows * plan.grid_cols * B} blocks): "
          f"{show(reads['new'])}; at iters=1 on the same blocks {one_us:.3f} "
          f"us device, so {(mean['device_us'] - one_us) / (iters - 1):.3f} us "
          f"a further sweep; plain {plain1:.4f}/{plain2:.4f} ms; bound "
          f"{max(bound_bytes_ms, bound_ops_ms) * 1e3:.2f} us")
    if base is not None:
        print(f"baseline {baseline}: neighbor_min_sweeps {show(reads['base'])}"
              f" (order {', '.join(order)})")
    results["neighbor_min_sweeps"] = {
        "name": "neighbor_min_sweeps",
        "route": "cuda",
        "source": "vtd_tpu_torch/csrc/neighbor_min_sweeps.cu",
        "replaces": "vtd_tpu/ops/pallas_kernels.py:55",
        "max_abs_err": max_diff,
        "ms": mean["ms"],
        "device_us": mean["device_us"],
        "host_us": mean["host_us"],
        "device_us_iters1": one_us,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
        **({} if base is None else {"baseline": {
            k: sum(r[k] for r in reads["base"]) / len(reads["base"])
            for k in mean}}),
    }
    one_map_check(torch, np, results, neighbor_min_sweeps,
                  neighbor_min_sweeps_plain, iters, plan.launches, card,
                  baseline)


def dense_phase(torch, np, results, baseline=None):
    """The dense labelling path, the only path of neighbor_min_sweeps:
    ``connected_components(backend="pallas")`` on the card against the same
    call on the CPU, with its wrapper calls and CUDA launches counted; its
    time per call in a loop of calls and on the device (CUDA graph), and
    the baseline checkout's beside it where one is given."""
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps
    from vtd_tpu_torch.ops.db_postprocess import connected_components

    rng = np.random.default_rng(2)
    cases = map_cases(np, rng, with_extremes=True)
    maps = np.stack([cases[i % len(cases)][1][i] for i in range(B)])
    fg = torch.from_numpy(maps).cuda()
    neighbor_min_sweeps.launches = 0
    neighbor_min_sweeps.cuda_launches = 0
    got = connected_components(fg, backend="pallas")
    torch.cuda.synchronize()
    launches = neighbor_min_sweeps.launches
    cuda_launches = neighbor_min_sweeps.cuda_launches
    want = connected_components(fg.cpu(), backend="pallas")
    if got.shape != (B, MAP * MAP) or got.dtype != torch.int32:
        raise AssertionError(f"dense labels malformed: {got.shape} {got.dtype}")
    if not torch.equal(got.cpu(), want):
        raise AssertionError(
            "connected_components(backend='pallas') on the card differs "
            "from the CPU's"
        )
    if launches != 4 or cuda_launches != 4:
        raise AssertionError(
            f"neighbor_min_sweeps: {launches} wrapper calls, {cuda_launches} "
            f"CUDA launches on the dense path; jump_rounds=4 at iters=8 "
            f"needs 4 of each"
        )
    record_launches(results, "neighbor_min_sweeps", "launches", launches)
    record_launches(results, "neighbor_min_sweeps", "cuda_launches",
                    cuda_launches)

    def dense():
        return connected_components(fg, backend="pallas")

    ms = time_ms(dense)
    device_us = graph_us(torch, dense, rounds=10)
    scan_ms = time_ms(lambda: connected_components(fg))
    line = (f"dense path: connected_components(backend='pallas') on "
            f"[{B}x{MAP}x{MAP}] equals the CPU's label for label, {launches} "
            f"wrapper calls = {cuda_launches} CUDA launches; {ms:.4f} ms per "
            f"call in a loop of calls, {device_us:.3f} us device time per "
            f"call (CUDA graph of 10 calls); scan backend on the same maps "
            f"{scan_ms:.4f} ms")
    if baseline is not None:
        old = importlib.import_module("vtd_baseline.ops.db_postprocess")

        def old_dense():
            return old.connected_components(fg, backend="pallas")

        if not torch.equal(old_dense(), got):
            raise AssertionError("the baseline's dense labels differ")
        line += (f"; baseline {baseline}: {time_ms(old_dense):.4f} ms, "
                 f"{graph_us(torch, old_dense, rounds=10):.3f} us device, "
                 f"then this tree again {graph_us(torch, dense, rounds=10):.3f}"
                 f" us device")
    results["neighbor_min_sweeps"]["dense_device_us"] = device_us
    print(line)


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


def stage_times(torch, pipe, frames, prob, card, label: str = ""):
    """Median wall time of each stage of one batch, host clock around
    work that ends in a synchronise (the labelling waits on the device
    inside postprocess anyway)."""
    from vtd_tpu_torch.ops.crop import crop_and_resize_boxes_mm
    from vtd_tpu_torch.ops.ctc import ctc_greedy_decode_arrays
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess
    from vtd_tpu_torch.ops.preprocess import yuv420_to_bgr

    bgr = yuv420_to_bgr(frames)
    frac = pipe.max_box_frac
    post = db_postprocess(prob, 0.5, max_dets=64, max_box_frac=frac)
    budget = pipe._effective_rec_budget(B)
    h, w = bgr.shape[1:3]
    size = pipe.detector.input_size
    scale = torch.tensor([w / size, h / size, w / size, h / size],
                         device=bgr.device)

    def crop_recognize():
        crops = crop_and_resize_boxes_mm(bgr, post["boxes"] * scale,
                                         post["valid"])
        crops = crops.reshape(-1, 32, 128, 3)[:budget]
        return ctc_greedy_decode_arrays(pipe.recognizer.logits(crops))

    stages = {
        "yuv420_to_bgr": lambda: yuv420_to_bgr(frames),
        "preprocess+dbnet": lambda: pipe.detector.probability(frames),
        "db_postprocess": lambda: db_postprocess(
            prob, 0.5, max_dets=64, max_box_frac=frac),
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
    n_valid = int(post["valid"].sum())
    print(f"stage ms per {B}-frame batch ({label}{n_valid} valid boxes, "
          f"median of 5): " + ", ".join(out) + f" ({card})")


def check_results_sized(outs, w: int, h: int) -> int:
    """The pipeline's result schema over a list of batches; returns the
    number of detections."""
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
                if not (0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h):
                    raise AssertionError(f"bbox out of frame {d['bbox']}")
                for c in ("detection_confidence", "recognition_confidence"):
                    if not 0.0 <= d[c] <= 1.0:
                        raise AssertionError(f"{c} out of range in {d}")
                if not isinstance(d["text"], str) or len(d["polygon"]) != 4:
                    raise AssertionError(f"malformed detection {d}")
                n_det += 1
    return n_det


def median_ms(torch, fn, runs: int = 5) -> float:
    """Median host-clock time of ``fn`` around synchronised work."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def trocr_numerics(torch, pipe):
    """The model on the card against references: a small float32 model
    against the CPU on the same seeded weights (logits 1e-3: float32 sums
    in another order; greedy tokens equal), and the full-width bf16 model
    against its own weights run in float32 on the card (printed, and held
    under a loose bound: random weights give logits of order 1)."""
    import dataclasses

    from vtd_tpu_torch.models.trocr import (
        TrOCR, greedy_generate, init_weights_, small_config,
    )

    gen = torch.Generator().manual_seed(11)
    cfg = small_config()
    cpu = init_weights_(TrOCR(cfg), gen).eval()
    gpu = TrOCR(cfg).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.cuda()
    images = torch.rand((4, cfg.image_size, cfg.width, 3), generator=gen) * 2 - 1
    tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen).int()
    # full float32 on the card for this comparison: cuDNN would otherwise
    # run the float32 patch-embedding convolution in TF32
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = cpu(images, tokens)
            got = gpu(images.cuda(), tokens.cuda()).cpu()
            err_small = float((got - want).abs().max())
            toks_c, conf_c = greedy_generate(cpu, images)
            toks_g, conf_g = greedy_generate(gpu, images.cuda())
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
    if not err_small <= 1e-3:
        raise AssertionError(f"small TrOCR card vs CPU logits differ by {err_small}")
    if not torch.equal(toks_c, toks_g.cpu()):
        raise AssertionError("small TrOCR greedy tokens differ card vs CPU")
    if not float((conf_c - conf_g.cpu()).abs().max()) <= 1e-3:
        raise AssertionError("small TrOCR confidences differ card vs CPU")

    tr = pipe.recognizer.transformer
    full32 = TrOCR(dataclasses.replace(tr.cfg, dtype=torch.float32)).eval()
    full32.load_state_dict(tr.model.state_dict())
    full32 = full32.cuda()
    c = tr.cfg
    images = (torch.rand((2, c.image_size, c.width, 3), generator=gen) * 2 - 1).cuda()
    tokens = torch.randint(0, c.vocab_size, (2, 12), generator=gen).int().cuda()
    with torch.inference_mode():
        l16 = tr.model(images, tokens)
        l32 = full32(images, tokens)
    if not (torch.isfinite(l16).all() and torch.isfinite(l32).all()):
        raise AssertionError("non-finite full-width TrOCR logits")
    err_full = float((l16 - l32).abs().max())
    scale = float(l32.abs().max())
    if not err_full <= 1.0:
        raise AssertionError(
            f"full-width bf16 logits are {err_full} from float32 (max |logit| "
            f"{scale})")
    del full32
    torch.cuda.empty_cache()
    print(f"TrOCR numerics: small float32 model card vs CPU logits within "
          f"{err_small:.2e}, greedy tokens equal; full-width bf16 vs float32 "
          f"on the card max logit diff {err_full:.4f} (max |logit| {scale:.3f})")


def trocr_stage_times(torch, pipe, frames, card, label: str = ""):
    """Median wall time of the TrOCR path's stages (host clock around
    synchronised work), one chunk = ``rec_chunk`` crops."""
    from vtd_tpu_torch.models.trocr import greedy_decode
    from vtd_tpu_torch.ops.crop import crop_and_resize_boxes_mm
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess
    from vtd_tpu_torch.ops.preprocess import yuv420_to_bgr

    tr = pipe.recognizer.transformer
    out_h, out_w = pipe.crop_hw
    chunk = pipe.rec_chunk
    state = {}

    def detect():
        state["bgr"] = yuv420_to_bgr(frames)
        prob = pipe.detector.probability(state["bgr"])
        state["post"] = db_postprocess(prob, 0.5, max_dets=64,
                                       max_box_frac=pipe.max_box_frac)

    def crop():
        post, bgr = state["post"], state["bgr"]
        h, w = bgr.shape[1:3]
        size = pipe.detector.input_size
        scale = torch.tensor([w / size, h / size, w / size, h / size],
                             device="cuda")
        crops = crop_and_resize_boxes_mm(
            bgr, post["boxes"] * scale, post["valid"], out_h=out_h, out_w=out_w)
        crops = ((crops.flip(-1) - 0.5) / 0.5).to(tr.cfg.dtype)
        state["crops"] = crops.reshape(-1, out_h, out_w, 3)

    def encode():
        state["enc_kvs"] = tr.model.encode_kv(state["crops"][:chunk])

    def decode():
        greedy_decode(tr.model, state["enc_kvs"], 1, 2)

    with torch.inference_mode():
        parts = [
            ("detect+postprocess", detect, 5), (f"crop {B * 64} slots to "
             f"{out_h}x{out_w}", crop, 5),
            (f"encoder+cross K/V (chunk of {chunk})", encode, 5),
            (f"decode loop {tr.cfg.max_len} steps (chunk of {chunk})", decode, 3),
        ]
        out = [f"{name} {median_ms(torch, fn, runs):.3f}"
               for name, fn, runs in parts]
    print(f"TrOCR path stage ms ({label}median): " + ", ".join(out)
          + f" ({card})")


def decode_attention_times(torch, card):
    """``ops/decode_attention.py`` at trocr-base's decoder shapes (bf16,
    16 heads of 64): the cross-attention over a chunk's 577 positions
    (16 rows, and a one-crop tail) and the self-attention's 50-slot cache
    at its last step. The kernel against the plain version first (within
    ``decode_attention.tolerance``, as the card tests hold it), then
    device us a call of the kernel, of the plain version and of
    ``F.scaled_dot_product_attention`` (a yardstick only; the port never
    calls it), each a CUDA graph over 12 K/V sets as a step's 12 layers
    read them (about 450 MB at 16 rows: the 50 MB L2 keeps none), beside
    the bound: K and V read once at 3.35 TB/s."""
    import torch.nn.functional as F

    from vtd_tpu_torch.ops import decode_attention as op

    heads, hd, layers = 16, 64, 12
    gen = torch.Generator(device="cuda").manual_seed(17)
    for name, b, t, pos in (("cross", 16, 577, None), ("cross", 1, 577, None),
                            ("self", 16, 50, 49)):
        sets = [tuple(torch.randn(shape, generator=gen, device="cuda")
                      .to(torch.bfloat16)
                      for shape in ((b, heads * hd), (b, t, heads, hd),
                                    (b, t, heads, hd)))
                for _ in range(layers)]
        p = None if pos is None else torch.tensor([pos], device="cuda")
        mask = (None if p is None else
                (torch.arange(t, device="cuda") <= p).view(1, 1, 1, t))
        q, k, v = sets[0]
        got = op.decode_attention(q, k, v, p).float()
        want = op.decode_attention_plain(q, k, v, p).float()
        # in units of the tolerance: 1 = at the limit the card tests hold
        gap = float(((got - want).abs()
                     / op.tolerance(q, k, v, p, want)).max())
        if not gap <= 1:
            raise AssertionError(
                f"decode_attention {name} B={b} T={t} is {gap:.3f} of its "
                f"tolerance from its plain version")

        def over_layers(fn):
            def call():
                for q, k, v in sets:
                    fn(q, k, v)
            return call

        def library(q, k, v):
            F.scaled_dot_product_attention(
                q.reshape(b, 1, heads, hd).transpose(1, 2),
                k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask)

        kern, plain, lib = (
            graph_us(torch, over_layers(fn), rounds=2, reps=10) / layers
            for fn in (lambda q, k, v: op.decode_attention(q, k, v, p),
                       lambda q, k, v: op.decode_attention_plain(q, k, v, p),
                       library))
        bound = 2 * b * t * heads * hd * 2 / HBM_BYTES_PER_S * 1e6
        print(f"decode_attention {name} B={b} T={t} bf16: kernel "
              f"{kern:.2f} us a call, bound {bound:.2f} us (K and V once; "
              f"{100 * bound / kern:.1f} % of it), plain {plain:.2f} us, "
              f"library_ms {lib / 1e3:.4f} (sdpa, yardstick); gap to the "
              f"plain version {gap:.3f} of its tolerance ({card})")


def trocr_graph_times(torch, tr, card):
    """The graphed decode (``runtime/trocr_runtime.py:GraphedDecode``)
    against the eager step loop on one chunk of ``pad_batch`` crops of the
    full-width model: a fresh replica's capture of its graphs (the
    ``vtd.trocr_capture`` span), the host ms ``generate`` takes to
    enqueue a chunk, wall ms (synchronised) and device ms (CUDA events) a
    chunk both ways; every row's tokens must agree, and the confidences
    within 1e-4."""
    from vtd_tpu_torch.models import trocr
    from vtd_tpu_torch.models.trocr import greedy_generate
    from vtd_tpu_torch.obs import trace
    from vtd_tpu_torch.ops import decode_attention as op

    c = tr.cfg
    gen = torch.Generator().manual_seed(13)
    crops = (torch.rand((tr.pad_batch, c.image_size, c.width, 3),
                        generator=gen) * 2 - 1).to(c.dtype).cuda()
    rep = tr.replica("cuda")
    torch.cuda.synchronize()
    trace.start()
    try:
        rep.generate(crops[:1])
        torch.cuda.synchronize()
    finally:
        trace.stop()
    spans = trace.snapshot()["spans"]
    cap = [s for s in spans if s.name == "vtd.trocr_capture"]
    if len(cap) != 1 or not rep._graphed:
        raise AssertionError(f"TrOCR graphs not captured: {cap}")
    cap_ms = (cap[0].t1_ns - cap[0].t0_ns) * 1e-6

    # the same graphs captured with the attention's plain version (the
    # arithmetic before the kernel), for the chunk's kernel time before
    old = tr.replica("cuda")
    trocr.decode_attention = op.decode_attention_plain
    try:
        old.generate(crops[:1])
    finally:
        trocr.decode_attention = op.decode_attention
    if any(old._graphed.launches):
        raise AssertionError("the plain-attention graphs launched the kernel")

    def graphed():
        return rep.generate(crops)

    def eager():
        return greedy_generate(rep.model, crops)

    def graphed_plain():
        return old.generate(crops)

    out = {}
    with torch.inference_mode():
        for name, fn in (("graphs", graphed), ("eager", eager),
                         ("plain", graphed_plain)):
            fn()
            host, wall, dev = [], [], []
            for _ in range(5):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.record()
                toks, conf = fn()
                t1 = time.perf_counter()
                b.record()
                torch.cuda.synchronize()
                host.append((t1 - t0) * 1e3)
                wall.append((time.perf_counter() - t0) * 1e3)
                dev.append(a.elapsed_time(b))
            out[name] = [sorted(x)[2] for x in (host, wall, dev)] + [toks, conf]
    del old
    rows = int((out["graphs"][3] == out["eager"][3]).all(dim=1).sum())
    conf_err = float((out["graphs"][4] - out["eager"][4]).abs().max())
    rows_plain = int((out["graphs"][3] == out["plain"][3]).all(dim=1).sum())
    print(f"TrOCR chunk of {tr.pad_batch} crops, graphed, device ms (medians "
          f"of 5): {out['graphs'][2]:.3f} with decode_attention, "
          f"{out['plain'][2]:.3f} with the plain attention captured instead "
          f"(before the kernel); tokens equal in {rows_plain} of "
          f"{tr.pad_batch} rows between the two ({card})")
    print(f"TrOCR graphed decode: {len(rep._graphed.graphs)} step graphs "
          f"captured in {cap_ms:.1f} ms (warm-up steps included); a chunk "
          f"of {tr.pad_batch} crops, medians of 5, host / wall / device ms: "
          f"graphs {out['graphs'][0]:.3f} / {out['graphs'][1]:.3f} / "
          f"{out['graphs'][2]:.3f}, eager {out['eager'][0]:.3f} / "
          f"{out['eager'][1]:.3f} / {out['eager'][2]:.3f}; tokens equal in "
          f"{rows} of {tr.pad_batch} rows, confidences within "
          f"{conf_err:.2e} ({card})")
    if rows != tr.pad_batch or conf_err > 1e-4:
        raise AssertionError(
            f"graphed TrOCR decode differs from the eager loop: tokens "
            f"equal in {rows} of {tr.pad_batch} rows, confidences within "
            f"{conf_err:.2e} (at most 1e-4)")


def trocr_phase(torch, np, card, results):
    """The TrOCR engine through VideoTextPipeline at full width: the
    default TrOCRConfig (384x384, patch 16, encoder 768x12, decoder
    1024x12, 50 steps, bf16) behind a ResNet50-FPN DBNet at 640x640,
    seeded weights, pipelined batches."""
    from vtd_tpu_torch.models.trocr import TrOCRConfig
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, segmented_cc_round,
    )
    from vtd_tpu_torch.ops.decode_attention import decode_attention
    from vtd_tpu_torch.runtime import VideoTextPipeline

    t0 = time.perf_counter()
    pipe = VideoTextPipeline(
        device="cuda", use_transformer_ocr=True, batch_size=B, max_dets=64,
        detector_input_size=640, host_downscale=640,
        transfer_format="yuv420", max_box_frac=1.0,
    )
    tr = pipe.recognizer.transformer
    if tr.cfg != TrOCRConfig() or pipe.crop_hw != (384, 384):
        raise AssertionError(f"not the full-width TrOCR config: {tr.cfg}")
    n_params = sum(p.numel() for p in tr.model.parameters())
    print(f"TrOCR pipeline built in {time.perf_counter() - t0:.1f} s: "
          f"{n_params / 1e6:.1f} M recogniser parameters, rec_chunk "
          f"{pipe.rec_chunk}")
    trocr_numerics(torch, pipe)

    chunks = []
    generate = tr.generate

    def counting_generate(crops):
        chunks.append(int(crops.shape[0]))
        return generate(crops)

    tr.generate = counting_generate
    valid = np.ones(B, bool)
    batches = [make_batch(np, k) for k in range(N_TROCR_BATCHES)]
    pipe.process_batch(batches[0], valid)  # warm-up: cuDNN and cuBLAS plans
    torch.cuda.synchronize()

    chunks.clear()
    reset_counts()
    outs, elapsed = run_pipelined(
        torch, pipe, [(b, valid, None) for b in batches])
    launches = segmented_cc_round.launches
    cuda_launches = segmented_cc_round.cuda_launches
    if launches < 3 * N_TROCR_BATCHES:
        raise AssertionError(
            f"segmented_cc_round launched {launches} times over "
            f"{N_TROCR_BATCHES} TrOCR batches; the path needs >= 3 per batch"
        )
    record_launches(results, "segmented_cc_round", "launches_trocr_path",
                    launches)
    record_launches(results, "segmented_cc_round", "cuda_launches_trocr_path",
                    cuda_launches)
    record_launches(results, "neighbor_min_sweeps", "launches_trocr_path",
                    neighbor_min_sweeps.launches)
    attn = decode_attention.launches
    record_launches(results, "decode_attention", "launches_trocr_path", attn)
    per_step = 2 * tr.cfg.dec_layers
    if attn != per_step * tr.cfg.max_len * len(chunks):
        raise AssertionError(
            f"decode_attention ran {attn} times over {len(chunks)} chunks of "
            f"{tr.cfg.max_len} steps; {per_step} a step expected")
    n_det = check_results_sized(outs, 640, 360)
    n_crops = sum(chunks)
    if n_crops != n_det or n_crops == 0:
        raise AssertionError(
            f"{n_crops} crops recognised for {n_det} detections")
    if max(chunks) > pipe.rec_chunk:
        raise AssertionError(f"a chunk of {max(chunks)} > rec_chunk")
    print(f"TrOCR path: {N_TROCR_BATCHES} pipelined batches x {B} frames, "
          f"{launches} segmented_cc_round calls ({cuda_launches} CUDA "
          f"launches), {n_det} detections, "
          f"{n_crops} crops recognised in {len(chunks)} chunks; "
          f"decode_attention {attn} launches ({per_step} a decode step)")
    print(f"TrOCR path throughput {B * N_TROCR_BATCHES / elapsed:.3f} frames/s "
          f"pipelined, {n_crops / elapsed:.3f} crops/s, "
          f"{elapsed / len(chunks) * 1e3:.3f} ms per chunk end to end "
          f"(seeded weights, bf16, {card})")
    del tr.generate  # the class's method again (a replica copies the attribute)
    trocr_stage_times(torch, pipe, torch.from_numpy(batches[0]).cuda(), card)
    decode_attention_times(torch, card)
    trocr_graph_times(torch, tr, card)


def pipeline_phase(torch, np, card, results):
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, segmented_cc_round,
    )
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

    reset_counts()
    outs, elapsed = run_pipelined(
        torch, pipe, [(b, valid, None) for b in batches])
    launches = segmented_cc_round.launches
    if launches < 3 * N_BATCHES:
        raise AssertionError(
            f"segmented_cc_round launched {launches} times over "
            f"{N_BATCHES} batches; the main path needs >= 3 per batch"
        )
    cuda_launches = segmented_cc_round.cuda_launches
    # the dense labelling kernel is on neither video path: 0 expected
    record_launches(results, "segmented_cc_round", "launches", launches)
    record_launches(results, "segmented_cc_round", "cuda_launches",
                    cuda_launches)
    record_launches(results, "neighbor_min_sweeps", "launches_crnn_path",
                    neighbor_min_sweeps.launches)
    from vtd_tpu_torch.ops.decode_attention import decode_attention

    record_launches(results, "decode_attention", "launches_crnn_path",
                    decode_attention.launches)

    n_det = check_results_sized(outs, 640, 360)

    t1 = time.perf_counter()
    pipe.process_batch(batches[1], valid)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t1
    print(f"main path: {N_BATCHES} batches x {B} frames, {launches} "
          f"segmented_cc_round calls ({cuda_launches} CUDA launches), "
          f"{n_det} detections")
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


TRUTH = ("HELLO", "WORLD", "123")
VERIFY_NPZ = "tests/torch_data/verify_frames.npz"
CHECKPOINTS = {
    "detector": "models/text_detector",
    "crnn": "models/text_recognizer",
    "trocr": "models/text_recognizer_trocr",
}
BOX_TOL_PX = 2  # trained boxes against the JAX package's, per coordinate
# one train step on the card against the CPU from the same weights: the
# card's float32 convolutions run in TF32 (PyTorch's default), 10 bits of
# mantissa against the CPU's 23
CARD_CPU_LOSS_RTOL = 1e-2
CARD_CPU_NORM_RTOL = 5e-2
DET_CONF_TOL = 0.01
REC_CONF_TOL = 0.05  # bf16 CRNN on the card against the reference's


def verify_frames(np):
    """The shipped frame (I420, 640x640) and the JAX package's reading of
    it (``tests/torch_data/make_verify_frames.py``)."""
    data = np.load(VERIFY_NPZ)
    return {k: data[k] for k in data.files}


def trained_pipeline(state, engine: str):
    """The trained pipeline at config 3's settings, built once per call of
    the script (the ``trained``, ``engine`` and ``beam`` phases share
    it)."""
    from vtd_tpu_torch.runtime import VideoTextPipeline

    key = f"pipe_{engine}"
    if key not in state:
        state[key] = VideoTextPipeline(
            detector_path=CHECKPOINTS["detector"],
            recognizer_path=CHECKPOINTS[engine],
            use_transformer_ocr=engine == "trocr", device="cuda",
            batch_size=B, max_dets=64, host_downscale=640,
            transfer_format="yuv420",
        )
    return state[key]


def check_against_reference(per_frame, ref, engine: str):
    """Each frame's detections against the JAX package's stored ones:
    transcripts equal (the set must be TRUTH), boxes within BOX_TOL_PX,
    confidences within their tolerances. Returns the largest errors."""
    import numpy as np

    texts = [str(t) for t in ref[f"{engine}_texts"]]
    if sorted(texts) != sorted(TRUTH):
        raise AssertionError(f"stored {engine} transcripts {texts}")
    want = {
        t: (ref[f"{engine}_boxes"][i], ref[f"{engine}_det_conf"][i],
            ref[f"{engine}_rec_conf"][i])
        for i, t in enumerate(texts)
    }
    err = {"box_px": 0.0, "det_conf": 0.0, "rec_conf": 0.0}
    for f, dets in enumerate(per_frame):
        got = sorted(d["text"] for d in dets)
        if got != sorted(texts):
            raise AssertionError(
                f"{engine} frame {f}: read {got}, the JAX package {texts}")
        for d in dets:
            box, det_conf, rec_conf = want[d["text"]]
            err["box_px"] = max(err["box_px"], float(
                np.abs(np.asarray(d["bbox"]) - box).max()))
            err["det_conf"] = max(err["det_conf"], abs(
                d["detection_confidence"] - float(det_conf)))
            err["rec_conf"] = max(err["rec_conf"], abs(
                d["recognition_confidence"] - float(rec_conf)))
    if not (err["box_px"] <= BOX_TOL_PX and err["det_conf"] <= DET_CONF_TOL
            and err["rec_conf"] <= REC_CONF_TOL):
        raise AssertionError(f"{engine} detections off the reference: {err}")
    return err


def run_pipelined(torch, pipe, plan):
    """Dispatch batch k+1 before collecting batch k over ``plan``, a list
    of (frames, valid, orig_size); returns the results and the wall
    time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = pipe.dispatch_batch(plan[0][0], valid_frames=plan[0][1])
    outs = []
    for k, (frames, valid, orig) in enumerate(plan):
        nxt = (
            pipe.dispatch_batch(plan[k + 1][0], valid_frames=plan[k + 1][1])
            if k + 1 < len(plan) else None
        )
        outs.append(pipe.process_batch(frames, valid, handles=handles,
                                       orig_size=orig))
        handles = nxt
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def reset_counts():
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, segmented_cc_round,
    )
    from vtd_tpu_torch.ops.decode_attention import decode_attention

    decode_attention.launches = 0
    segmented_cc_round.launches = 0
    segmented_cc_round.cuda_launches = 0
    neighbor_min_sweeps.launches = 0
    neighbor_min_sweeps.cuda_launches = 0


def record_path(results, path: str) -> tuple:
    """The kernels' counts since :func:`reset_counts`, into the kernels
    line under ``path``; returns the labelling kernel's (calls, CUDA
    launches)."""
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, segmented_cc_round,
    )
    from vtd_tpu_torch.ops.decode_attention import decode_attention

    record_launches(results, "decode_attention", f"launches_{path}",
                    decode_attention.launches)

    calls, cuda = segmented_cc_round.launches, segmented_cc_round.cuda_launches
    record_launches(results, "segmented_cc_round", f"launches_{path}", calls)
    record_launches(results, "segmented_cc_round", f"cuda_launches_{path}",
                    cuda)
    record_launches(results, "neighbor_min_sweeps", f"launches_{path}",
                    neighbor_min_sweeps.launches)
    return calls, cuda


def trained_phase(torch, np, card, results, state):
    """The repo's trained checkpoints on the card: restore with the
    port's reader, the CRNN and TrOCR paths at config 3's settings on the
    shipped frame, results against the JAX package's."""
    from vtd_tpu_torch.train.checkpoint import restore_variables

    for name, path in CHECKPOINTS.items():
        t0 = time.perf_counter()
        tree = restore_variables(path)
        secs = time.perf_counter() - t0
        n = 0
        stack = [tree]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            else:
                n += int(node.size)
        print(f"restore {path}: {secs:.3f} s, {n / 1e6:.2f} M values "
              f"(port's OCDBT reader, libzstd)")
    ref = verify_frames(np)
    frames = np.stack([ref["frame_i420"]] * B)
    valid = np.ones(B, bool)
    for engine in ("crnn", "trocr"):
        t0 = time.perf_counter()
        pipe = trained_pipeline(state, engine)
        print(f"trained {engine} pipeline built in "
              f"{time.perf_counter() - t0:.1f} s")
        pipe.process_batch(frames, valid)  # warm-up
        reset_counts()
        outs, elapsed = run_pipelined(
            torch, pipe, [(frames, valid, None)] * N_BATCHES)
        calls, cuda = record_path(results, f"trained_{engine}_path")
        if calls < 3 * N_BATCHES:
            raise AssertionError(
                f"segmented_cc_round launched {calls} times over "
                f"{N_BATCHES} trained {engine} batches")
        n_det = check_results_sized(outs, 640, 640)
        errs = [check_against_reference(o, ref, engine) for o in outs]
        worst = {k: max(e[k] for e in errs) for k in errs[0]}
        print(f"trained {engine} path: {N_BATCHES} pipelined batches x {B} "
              f"frames, {n_det} detections, every frame reads "
              f"{sorted(TRUTH)} as the JAX package does; largest "
              f"differences: box {worst['box_px']} px, detection confidence "
              f"{worst['det_conf']:.5f}, recognition confidence "
              f"{worst['rec_conf']:.5f}; {calls} segmented_cc_round calls "
              f"({cuda} CUDA launches)")
        print(f"trained {engine} throughput {B * N_BATCHES / elapsed:.3f} "
              f"frames/s pipelined ({card})")
        frames_dev = torch.from_numpy(frames).cuda()
        with torch.inference_mode():
            if engine == "crnn":
                prob = pipe.detector.probability(frames_dev)
                stage_times(torch, pipe, frames_dev, prob, card,
                            label="trained weights, ")
            else:
                trocr_stage_times(torch, pipe, frames_dev, card,
                                  label="trained weights, ")


def engine_phase(torch, np, card, results, state):
    """InferenceEngine on the trained CRNN pipeline: three streams of
    stacked batches and one of single frames, every Future against
    process_batch on the same frames."""
    from vtd_tpu_torch.runtime import InferenceEngine

    pipe = trained_pipeline(state, "crnn")
    ref = verify_frames(np)
    valid = np.ones(B, bool)
    shipped = np.stack([ref["frame_i420"]] * B)
    streams = [
        [shipped] * 3,
        [make_batch(np, k) for k in range(3)],
        [make_batch(np, k) for k in range(3, 6)],
    ]
    part = valid.copy()
    part[B // 2:] = False  # a stream's last, partly filled batch
    masks = [[valid, valid, valid], [valid, valid, part],
             [valid, valid, valid]]
    orig = [(640, 640), (360, 640), (360, 640)]
    single = [make_batch(np, 7)[i] for i in range(B)]  # one stream, framewise
    pipe.process_batch(streams[1][0], valid)  # warm-up at this shape
    want = [[pipe.process_batch(b, m, orig_size=o) for b, m in zip(s, ms)]
            for s, ms, o in zip(streams, masks, orig)]
    want_single = pipe.process_batch(np.stack(single), valid,
                                     orig_size=(360, 640))
    torch.cuda.synchronize()

    # the single frames go in first, so that the scheduler takes all 16
    # into one bucket before it dispatches a stacked batch
    engine = InferenceEngine(pipeline=pipe)
    reset_counts()
    t0 = time.perf_counter()
    single_futs = [engine.submit_frame(f, orig_size=(360, 640))
                   for f in single]
    futs = [[engine.submit_batch(b, m, orig_size=o) for b, m in zip(s, ms)]
            for s, ms, o in zip(streams, masks, orig)]
    got = [[f.result(timeout=300) for f in fs] for fs in futs]
    got_single = [f.result(timeout=300) for f in single_futs]
    elapsed = time.perf_counter() - t0
    dispatched = engine.batches_dispatched
    engine.close()
    calls, cuda = record_path(results, "engine_path")
    n_frames = sum(int(m.sum()) for ms in masks for m in ms) + len(single)
    for s, (g, w, ms) in enumerate(zip(got, want, masks)):
        for k, (gb, wb, m) in enumerate(zip(g, w, ms)):
            if [gb[i] for i in np.nonzero(m)[0]] != [
                    wb[i] for i in np.nonzero(m)[0]]:
                raise AssertionError(
                    f"engine stream {s} batch {k} differs from process_batch")
    if got_single != want_single:
        raise AssertionError("engine submit_frame results differ from "
                             "process_batch")
    if dispatched != 3 * 3 + 1:
        raise AssertionError(f"{dispatched} batches dispatched, expected 10")
    n_det = sum(len(d) for g in got for b in g for d in b) + sum(
        len(d) for d in got_single)
    print(f"engine: 3 streams via submit_batch + 1 via submit_frame, "
          f"{n_frames} frames, {dispatched} batches dispatched, {n_det} "
          f"detections, every Future equal to process_batch; "
          f"{calls} segmented_cc_round calls ({cuda} CUDA launches)")
    # the same 10 batches straight through the pipeline, pipelined
    plan = [(np.stack(single), valid, (360, 640))] + [
        (b, m, o) for s, ms, o in zip(streams, masks, orig)
        for b, m in zip(s, ms)]
    _, direct = run_pipelined(torch, pipe, plan)
    print(f"engine aggregate {n_frames / elapsed:.3f} frames/s over "
          f"{elapsed * 1e3:.3f} ms; the same batches straight through the "
          f"pipeline (dispatch k+1, then collect k) {n_frames / direct:.3f} "
          f"frames/s (trained CRNN, bf16, {card})")


# a fresh process loads the library build(force=True) rewrote and holds
# its beam against the plain beam
REBUILT_BEAM_CODE = """
import numpy as np
from vtd_tpu_torch import native
gen = np.random.default_rng(16)
logits = gen.normal(0.0, 3.0, (16, 32, 40)).astype(np.float32)
lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
seqs, scores = native.ctc_beam_decode(lp, beam_width=8)
pseqs, pscores = native.ctc_beam_decode_plain(lp, beam_width=8)
assert seqs == pseqs and float(np.abs(scores - pscores).max()) <= 1e-4
print("REBUILT BEAM OK", native.build().name)
"""


def force_build(native, card):
    """``build(force=True)`` of both native libraries, as the reference's
    ``build`` takes it: the CTC beam compiled again into its target (the
    seconds g++ takes; a fresh process decodes with the rebuilt library
    as the plain beam does); the libav decoder rebuilt where libav is
    present, else raising ``RuntimeError`` naming what is missing."""
    import os

    target = native.build()
    stamp = os.stat(target)
    t0 = time.perf_counter()
    if native.build(force=True) != target:
        raise AssertionError("build(force=True) wrote another target")
    seconds = time.perf_counter() - t0
    after = os.stat(target)
    if (after.st_mtime_ns, after.st_ino) == (stamp.st_mtime_ns, stamp.st_ino):
        raise AssertionError("build(force=True) left the library as it was")
    child = subprocess.run(
        [sys.executable, "-c", REBUILT_BEAM_CODE], capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__))))
    if child.returncode != 0 or "REBUILT BEAM OK" not in child.stdout:
        raise AssertionError(f"the rebuilt beam: {child.stdout}{child.stderr}")
    missing = native.video.libav_missing()
    if missing:
        try:
            native.video.build(force=True)
        except RuntimeError as e:
            video = f"raises RuntimeError ({e})"
        else:
            raise AssertionError("video.build(force=True) built without libav")
    else:
        t1 = time.perf_counter()
        native.video.build(force=True)
        video = f"rebuilt in {time.perf_counter() - t1:.1f} s"
    print(f"native.build(force=True): {target.name} compiled again by g++ in "
          f"{seconds:.2f} s (new file); a fresh process decodes with it as "
          f"the plain beam does; native.video.build(force=True) {video} "
          f"({card})")


def beam_phase(torch, np, card, state):
    """The C++ CTC prefix beam against the plain Python beam."""
    from vtd_tpu_torch import native
    from vtd_tpu_torch.models.crnn import build_vocab
    from vtd_tpu_torch.ops.crop import crop_and_resize_boxes_mm
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess
    from vtd_tpu_torch.ops.preprocess import yuv420_to_bgr
    from vtd_tpu_torch.runtime import TextRecognizer

    t0 = time.perf_counter()
    lib = native.build()
    print(f"built {lib.name} with g++ in {time.perf_counter() - t0:.1f} s")
    force_build(native, card)
    pipe = trained_pipeline(state, "crnn")
    ref = verify_frames(np)
    frames = torch.from_numpy(np.stack([ref["frame_i420"]] * B)).cuda()
    with torch.inference_mode():
        bgr = yuv420_to_bgr(frames)
        post = db_postprocess(pipe.detector.probability(bgr), 0.5,
                              max_dets=64, max_box_frac=pipe.max_box_frac)
        crops = crop_and_resize_boxes_mm(bgr, post["boxes"], post["valid"])
        crops = crops[post["valid"]]
        trained_lp = pipe.recognizer.log_probs(crops).cpu().numpy()
    v = len(build_vocab())
    gen = np.random.default_rng(6)
    logits = gen.normal(0.0, 3.0, (64, 32, v)).astype(np.float32)
    random_lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    out = []
    for name, lp in (("trained CRNN", trained_lp),
                     ("seeded random", random_lp.astype(np.float32))):
        seqs, scores = native.ctc_beam_decode(lp, beam_width=8)
        t0 = time.perf_counter()
        for _ in range(10):
            native.ctc_beam_decode(lp, beam_width=8)
        ms = (time.perf_counter() - t0) / 10 * 1e3
        t0 = time.perf_counter()
        pseqs, pscores = native.ctc_beam_decode_plain(lp, beam_width=8)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if seqs != pseqs:
            raise AssertionError(f"beam sequences differ on {name} log-probs")
        err = float(np.abs(scores - pscores).max())
        if not err <= 1e-4:
            raise AssertionError(f"beam scores differ by {err} on {name}")
        out.append(f"{name} [{lp.shape[0]}, {lp.shape[1]}, {lp.shape[2]}]: "
                   f"{ms:.3f} ms per batch (plain Python {plain_ms:.3f} ms), "
                   f"scores within {err:.2e}")
    rec = TextRecognizer(CHECKPOINTS["crnn"], use_transformer=False,
                         decoder="beam", beam_width=8, pad_batch=128,
                         device="cuda")
    texts, confs = rec.recognize_crops_device(crops)
    if sorted(texts) != sorted(TRUTH * B):
        raise AssertionError(f"beam decoder read {sorted(set(texts))}")
    print("C++ beam equals the plain beam (sequences equal): "
          + "; ".join(out) + f"; TextRecognizer(decoder='beam') reads "
          f"{sorted(set(texts))} on the {len(texts)} trained crops "
          f"({card})")


# published dense peaks of one H100 SXM (at 700 W), by the type that ran
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def forward_flops(torch, model, *args) -> int:
    """FLOPs of one forward, counted from the shapes by PyTorch's
    ``FlopCounterMode`` (convolutions and matrix products), plus 2*B*T*4H*
    (I+H) a direction and layer for each ``nn.LSTM`` when the counter does
    not see inside it (cuDNN's RNN is one op to it)."""
    from torch.utils.flop_counter import FlopCounterMode

    lstms = [m for m in model.modules() if isinstance(m, torch.nn.LSTM)]
    seen = False
    if lstms:
        m = lstms[0]
        with torch.no_grad(), FlopCounterMode(display=False) as probe:
            m(torch.zeros(1, 2, m.input_size, device=m.weight_ih_l0.device))
        seen = probe.get_total_flops() > 0
    extra = []

    def lstm_hook(m, inp, out):
        b, t = inp[0].shape[:2]
        h, width = m.hidden_size, m.input_size
        for _ in range(m.num_layers):
            extra.append(2 * (2 * b * t * 4 * h * (width + h)))
            width = 2 * h

    hooks = [] if seen else [m.register_forward_hook(lstm_hook)
                             for m in lstms]
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model(*args)
    finally:
        for hk in hooks:
            hk.remove()
    return fc.get_total_flops() + sum(extra)


def timed_steps(torch, step, n: int):
    """``n`` calls of ``step()`` each between CUDA events -> (ms per call,
    the values ``step`` returned as floats, read after the last call)."""
    out, ms = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.append(step())
        end.record()
        ms.append((start, end))
    torch.cuda.synchronize()
    return ([a.elapsed_time(b) for a, b in ms], [float(v) for v in out])


def device_profile(torch, step, n: int = 2) -> str:
    """``n`` more calls of ``step()`` under ``torch.profiler``: the device's
    busy share of the wall time (kernel time over wall time, the profiler
    on) and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    if busy == 0:
        return "device time: not measured (the profiler saw no kernel)"
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    return (f"device busy {busy / wall:.1%} of {wall / n * 1e3:.3f} ms a "
            f"step with the profiler on, {len(kern)} kernel names; top: "
            + "; ".join(f"{e.key[:48]} {e.self_device_time_total / n / 1e3:.3f}"
                        f" ms" for e in top))


def report_steps(torch, np, card, name, batch, ms, losses, flops, kind,
                 falls=True):
    """The per-model training line; fails on a non-finite loss and, with
    ``falls``, on a last loss not below the first."""
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    if falls and not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    med = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated() / 2**30
    share = flops * 3 / (med / 1e3) / PEAK_FLOPS[kind]
    print(f"train {name}: {med:.3f} ms/step (median of {len(ms)}), "
          f"{batch / med * 1e3:.1f} samples/s, peak memory {peak:.2f} GiB, "
          f"{flops * 3 / 1e9:.1f} GFLOP a step (forward x3) = {share:.1%} "
          f"of the {kind} peak {PEAK_FLOPS[kind] / 1e12:.0f} TFLOP/s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({card})")


def grad_norm(torch, model) -> float:
    """The norm of every gradient together (a split model's shards may lie
    on several cards)."""
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum().cpu()
                                for p in model.parameters()
                                if p.grad is not None)))


def card_against_cpu(torch, name, run, loss_rtol, norm_rtol):
    """``run(device) -> (loss, model)``: one step from the same weights on
    the card and on the CPU (lr 0); the loss and the global gradient norm
    within the stated tolerances."""
    got = {}
    for dev in ("cuda", "cpu"):
        loss, model = run(dev)
        got[dev] = (float(loss), grad_norm(torch, model))
    (lc, nc), (lp, ncpu) = got["cuda"], got["cpu"]
    dl, dn = abs(lc - lp) / abs(lp), abs(nc - ncpu) / ncpu
    print(f"card against CPU, {name}: loss {lc:.6f} / {lp:.6f} (rel "
          f"{dl:.2e}, allowed {loss_rtol:g}), gradient norm {nc:.6f} / "
          f"{ncpu:.6f} (rel {dn:.2e}, allowed {norm_rtol:g})")
    if not (dl <= loss_rtol and dn <= norm_rtol):
        raise AssertionError(f"{name}: the card's step differs from the CPU's")


def train_phase(torch, np, card):
    """The port's training on the card: the DBNet, CRNN and TrOCR train
    steps at full width (timed, the loss falling), the detector and
    recognizer trainers end to end with their checkpoints read back by the
    runtime, the default TrOCRConfig in bf16 with float32 weights, and one
    step of the DBNet and the CRNN on the card against the CPU."""
    import tempfile

    from vtd_tpu_torch.convert import crnn_from_jax, dbnet_from_jax
    from vtd_tpu_torch.core.device import seeded_init_
    from vtd_tpu_torch.models.crnn import CRNN
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.models.trocr import (
        CharTokenizer, TrOCR, TrOCRConfig, init_weights_,
    )
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, segmented_cc_round,
    )
    from vtd_tpu_torch.runtime import TextDetector, TextRecognizer
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer
    from vtd_tpu_torch.train.checkpoint import load_weights, save_state_dict
    from vtd_tpu_torch.train.recognizer_trainer import (
        RecognizerTrainer, encode_labels, make_crnn_train_step,
        synthesize_text_lines,
    )
    from vtd_tpu_torch.train.train_detector import synthesize_detection_data
    from vtd_tpu_torch.train.trainer import (
        ModelTrainer, TextDetectionDataset, create_train_state,
        make_train_step,
    )
    from vtd_tpu_torch.train.trocr_trainer import (
        demo_config, encode_tokens, make_trocr_train_step, pack_u8,
        save_config, synthesize_trocr_crops, warmup_cosine,
    )

    tf32 = torch.backends.cudnn.allow_tf32
    conv_kind = "tf32" if tf32 else "float32"
    print(f"TF32 as the trainers see it: cudnn.allow_tf32={tf32} (float32 "
          f"convolutions and cuDNN's LSTM), cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} (float32 matrix products)")
    reset_counts()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        # -- DBNet, ResNet50-FPN at 640x640, batch 8, float32 -------------
        imgs, tgts = synthesize_detection_data(8, 640, seed=0)
        st = create_train_state(DBNet(dtype=torch.float32), seed=0,
                                device="cuda")
        step = make_train_step(st["model"], st["optimizer"])
        x = torch.from_numpy(imgs).to(dev)
        t = {k: torch.from_numpy(v).to(dev) for k, v in tgts.items()}
        flops = forward_flops(torch, st["model"].eval(), x.permute(0, 3, 1, 2))
        torch.cuda.reset_peak_memory_stats()
        timed_steps(torch, lambda: step(x, t)["loss"], 2)
        ms, losses = timed_steps(torch, lambda: step(x, t)["loss"], 10)
        report_steps(torch, np, card, "DBNet 640x640 b8 float32", 8, ms,
                     losses, flops, conv_kind)
        print("  " + device_profile(torch, lambda: step(x, t)))
        del st, step, x, t

        images, targets = synthesize_detection_data(64, 160)
        split = 64 * 4 // 5
        trainer = ModelTrainer(
            {"checkpoint_dir": f"{tmp}/dbnet", "max_epochs": 2,
             "batch_size": 8, "learning_rate": 1e-4, "weight_decay": 1e-5},
            device="cuda")
        t0 = time.perf_counter()
        res = trainer.train(
            DBNet(dtype=torch.float32),
            TextDetectionDataset(images[:split],
                                 {k: v[:split] for k, v in targets.items()}),
            TextDetectionDataset(images[split:],
                                 {k: v[split:] for k, v in targets.items()}))
        if res["status"] != "success":
            raise AssertionError(f"ModelTrainer failed: {res}")
        det = TextDetector(model_path=res["best_model_path"], input_size=160,
                           device="cuda")
        frames = torch.from_numpy((images[:4] * 255).astype(np.uint8)).to(dev)
        with torch.inference_mode():
            prob = det.probability(frames)
        if not (prob.shape == (4, 160, 160) and torch.isfinite(prob).all()):
            raise AssertionError("the trained detector's maps are not finite")
        print(f"ModelTrainer: 2 epochs on 51 + 13 frames of 160x160 in "
              f"{time.perf_counter() - t0:.1f} s, val_loss "
              f"{res['best_val_loss']:.4f}, best checkpoint "
              f"{res['best_model_path'].rsplit('/', 1)[-1]} read by "
              f"TextDetector: finite maps")
        del det, trainer, prob, frames

        # -- CRNN, 2x BiLSTM 256, batch 32 of 32x128, CTC on the card ------
        crops, texts = synthesize_text_lines(32, seed=0)
        labels, pads = encode_labels(texts)
        model = seeded_init_(CRNN(dtype=torch.float32), 0).to(dev)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                weight_decay=1e-5)
        step = make_crnn_train_step(
            model, opt, augment=True,
            generator=torch.Generator(device=dev).manual_seed(11))
        xb = torch.from_numpy(crops).to(dev)
        lb, pb = (torch.from_numpy(a).to(dev) for a in (labels, pads))
        flops = forward_flops(torch, model.eval(), xb.permute(0, 3, 1, 2))
        torch.cuda.reset_peak_memory_stats()
        timed_steps(torch, lambda: step(xb, lb, pb), 2)
        ms, losses = timed_steps(torch, lambda: step(xb, lb, pb), 10)
        report_steps(torch, np, card, "CRNN b32 float32", 32, ms, losses,
                     flops, conv_kind)
        print("  " + device_profile(torch, lambda: step(xb, lb, pb)))

        lines, line_texts = synthesize_text_lines(256)
        t0 = time.perf_counter()
        res = RecognizerTrainer(
            {"checkpoint_dir": f"{tmp}/crnn", "max_epochs": 1,
             "batch_size": 32, "learning_rate": 1e-3},
            device="cuda").train(lines[:204], line_texts[:204], lines[204:],
                                 line_texts[204:])
        if res["status"] != "success":
            raise AssertionError(f"RecognizerTrainer failed: {res}")
        rec = TextRecognizer(model_path=res["best_model_path"],
                             use_transformer=False, device="cuda")
        read = rec.recognize_batch([(lines[0] * 255).astype(np.uint8)])
        if not isinstance(read[0]["text"], str):
            raise AssertionError("the trained CRNN did not read a crop")
        print(f"RecognizerTrainer: 1 epoch on 204 lines in "
              f"{time.perf_counter() - t0:.1f} s, loss "
              f"{res['final_loss']:.4f}; crnn_final.pt read by TextRecognizer "
              f"on the card: {read[0]['text']!r} for {line_texts[0]!r}")

        # -- TrOCR demo config (48x192, 128x4, float32), batch 32 ----------
        cfg = demo_config()
        tok = CharTokenizer()
        timgs, ttexts = synthesize_trocr_crops(32, cfg, seed=0)
        u8 = torch.from_numpy(pack_u8(timgs)).to(dev)
        tokens = torch.from_numpy(
            encode_tokens(ttexts, tok, cfg.max_len)).to(dev)
        model = TrOCR(cfg).float()
        init_weights_(model, torch.Generator().manual_seed(0))
        model.to(dev)
        opt = torch.optim.AdamW(model.parameters(), lr=0.0, weight_decay=1e-4)
        step = make_trocr_train_step(
            model, opt, schedule=lambda n: warmup_cosine(n, 1e-3, 2, 100),
            augment=True,
            generator=torch.Generator(device=dev).manual_seed(7))
        xf = u8.float() / 127.5 - 1.0
        flops = forward_flops(torch, model.eval(), xf, tokens[:, :-1])
        torch.cuda.reset_peak_memory_stats()
        timed_steps(torch, lambda: step(u8, tokens), 2)
        ms, losses = timed_steps(torch, lambda: step(u8, tokens), 10)
        report_steps(
            torch, np, card, "TrOCR demo 48x192 128x4 b32 float32", 32, ms,
            losses, flops, "float32")
        print("  " + device_profile(torch, lambda: step(u8, tokens)))
        path = save_state_dict(f"{tmp}/trocr/trocr_final.pt", model)
        save_config(f"{tmp}/trocr/trocr_final_config.json", cfg)
        back = TransformerRecognizer(model_path=path, device="cuda")
        for k, v in back.model.state_dict().items():
            if not torch.equal(v, model.state_dict()[k]):
                raise AssertionError(f"TrOCR reload differs at {k}")
        back.recognize((timgs[0] * 127.5 + 127.5).astype(np.uint8))
        print("TrOCR demo: trocr_final.pt + trocr_final_config.json read "
              "back by TransformerRecognizer, weights equal")

    # -- default TrOCRConfig (384^2, 768x12 / 1024x12), bf16, batch 16 ----
    cfg = TrOCRConfig(vocab_size=CharTokenizer().vocab_size)
    model = TrOCR(cfg).float()  # float32 master weights, bf16 compute
    init_weights_(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    model.to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, weight_decay=1e-4)
    step = make_trocr_train_step(
        model, opt, schedule=lambda n: warmup_cosine(n, 1e-4, 1, 100))
    timgs, ttexts = synthesize_trocr_crops(16, cfg, seed=1)
    u8 = torch.from_numpy(pack_u8(timgs)).to(dev)
    tokens = torch.from_numpy(
        encode_tokens(ttexts, CharTokenizer(), cfg.max_len)).to(dev)
    flops = forward_flops(torch, model.eval(), u8.float() / 127.5 - 1.0,
                          tokens[:, :-1])
    torch.cuda.reset_peak_memory_stats()
    timed_steps(torch, lambda: step(u8, tokens), 1)
    ms, losses = timed_steps(torch, lambda: step(u8, tokens), 5)
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("TrOCR master weights left float32")
    report_steps(
        torch, np, card, f"TrOCR default config ({n_params / 1e6:.1f} M "
        f"parameters) b16 bf16 compute, float32 weights", 16, ms, losses,
        flops, "bfloat16", falls=False)
    print("  " + device_profile(torch, lambda: step(u8, tokens)))
    del model, opt, step

    # -- one step on the card against the CPU, the trained weights --------
    det_w = load_weights(CHECKPOINTS["detector"], dbnet_from_jax)
    imgs, tgts = synthesize_detection_data(2, 160, seed=1)

    def db_run(d):
        st = create_train_state(DBNet(dtype=torch.float32), learning_rate=0.0,
                                weights=det_w, device=d)
        loss = make_train_step(st["model"], st["optimizer"])(
            torch.from_numpy(imgs).to(d),
            {k: torch.from_numpy(v).to(d) for k, v in tgts.items()})["loss"]
        return loss, st["model"]

    card_against_cpu(torch, "DBNet 160x160 b2 (models/text_detector)",
                     db_run, CARD_CPU_LOSS_RTOL, CARD_CPU_NORM_RTOL)
    crnn_w = load_weights(CHECKPOINTS["crnn"], crnn_from_jax)
    crops, texts = synthesize_text_lines(8, seed=1)
    labels, pads = encode_labels(texts)

    def crnn_run(d):
        m = CRNN(dtype=torch.float32)
        m.load_state_dict(crnn_w)
        m.to(d)
        opt = torch.optim.AdamW(m.parameters(), lr=0.0)
        loss = make_crnn_train_step(m, opt)(
            torch.from_numpy(crops).to(d), torch.from_numpy(labels).to(d),
            torch.from_numpy(pads).to(d))
        return loss, m

    card_against_cpu(torch, "CRNN b8 (models/text_recognizer)", crnn_run,
                     CARD_CPU_LOSS_RTOL, CARD_CPU_NORM_RTOL)
    print(f"train path: segmented_cc_round {segmented_cc_round.launches} "
          f"calls, neighbor_min_sweeps {neighbor_min_sweeps.launches} calls "
          f"(training launches neither TPU kernel)")


SERVE_FPS = 30.0
SERVE_SECONDS = 2  # 20 stride candidates at the default 10 fps
JOB_DEADLINE_S = 120.0
SERVE_BOX_TOL_PX = 1  # a job run alone against the same job run beside another
SERVE_CONF_TOL = 1e-3


def write_serve_clip(np, path: str) -> int:
    """The shipped frame for the first second, then the same text moved
    240 px right (a scene change for the keyframe gate), as mp4v; returns
    the frame count."""
    import cv2

    frame = verify_frames(np)["frame_bgr"]
    moved = np.empty_like(frame)
    moved[:] = frame[0, 0]
    moved[:, 240:] = frame[:, :400]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             SERVE_FPS, (640, 640))
    if not writer.isOpened():
        raise RuntimeError("cv2 cannot write mp4v")
    n = int(SERVE_FPS * SERVE_SECONDS)
    for i in range(n):
        writer.write(frame if i < n // 2 else moved)
    writer.release()
    return n


class Api:
    """A urllib client of the service, with proxies off (the server is on
    127.0.0.1)."""

    def __init__(self, base: str):
        import urllib.request

        self.base = base
        self.headers: dict = {}
        self._open = urllib.request.build_opener(
            urllib.request.ProxyHandler({})).open

    def call(self, method, path, data=None, ctype=None, query=None,
             timeout=60.0):
        import urllib.error
        import urllib.parse
        import urllib.request

        url = self.base + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers = dict(self.headers)
        if ctype:
            headers["Content-Type"] = ctype
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with self._open(req, timeout=timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def json(self, method, path, expect=200, **kw):
        status, body = self.call(method, path, **kw)
        if status != expect:
            raise AssertionError(
                f"{method} {path}: HTTP {status} {body[:400]!r}")
        return json.loads(body) if body else None

    def upload(self, name: str, content: bytes) -> dict:
        boundary = "vtdsmokeboundary"
        body = (
            f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
            f'filename="{name}"\r\nContent-Type: video/mp4\r\n\r\n'
        ).encode() + content + f"\r\n--{boundary}--\r\n".encode()
        return self.json(
            "POST", "/api/v1/videos/upload", expect=201, data=body,
            ctype=f"multipart/form-data; boundary={boundary}")

    def detect(self, video_id: int, **query) -> tuple:
        """POST detect; returns (job id, the time it was posted)."""
        t0 = time.perf_counter()
        job = self.json("POST",
                        f"/api/v1/processing/videos/{video_id}/detect",
                        query=query)
        return job["id"], t0

    def wait(self, job_id: int, t0: float) -> tuple:
        """Poll the job's status every 20 ms until it ends; returns (the
        job row with its result_data, seconds from the POST to the first
        poll that read 'completed')."""
        deadline = t0 + JOB_DEADLINE_S
        while True:
            st = self.json("GET", f"/api/v1/processing/jobs/{job_id}/status")
            if st["status"] in ("completed", "failed", "cancelled"):
                wall = time.perf_counter() - t0
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"job {job_id} not done: {st}")
            time.sleep(0.02)
        if st["status"] != "completed":
            raise AssertionError(f"job {job_id} {st['status']}: "
                                 f"{st['error_message']}")
        return self.json("GET", f"/api/v1/processing/jobs/{job_id}"), wall


def wait_ready(api, deadline_s: float) -> tuple:
    """Poll /health/ready until it answers; (status, body, seconds)."""
    import urllib.error

    t0 = time.perf_counter()
    while True:
        try:
            status, body = api.call("GET", "/health/ready", timeout=30.0)
            return status, body, time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            if time.perf_counter() - t0 > deadline_s:
                raise
            time.sleep(0.05)


def check_served_texts(result: dict, label: str, n_frames: int) -> int:
    """Every sampled frame of a job reads TRUTH; returns the detections."""
    frames = result["results"]
    if [f["frame_number"] for f in frames] != list(range(n_frames)):
        raise AssertionError(f"{label}: frames "
                             f"{[f['frame_number'] for f in frames]}")
    for f in frames:
        got = sorted(d["text"] for d in f["detections"])
        if got != sorted(TRUTH):
            raise AssertionError(
                f"{label} frame {f['frame_number']}: read {got}, the "
                f"trained phase reads {sorted(TRUTH)}")
    return sum(len(f["detections"]) for f in frames)


def same_frames(got, want, label: str) -> None:
    """Two runs' per-frame detections: texts equal, boxes within
    SERVE_BOX_TOL_PX, detection confidences within SERVE_CONF_TOL."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} frames, {len(want)}")
    for f, (x, y) in enumerate(zip(got, want)):
        dx = sorted(x, key=lambda d: d["text"])
        dy = sorted(y, key=lambda d: d["text"])
        if [d["text"] for d in dx] != [d["text"] for d in dy]:
            raise AssertionError(f"{label} frame {f}: texts")
        for p, q in zip(dx, dy):
            box = max(abs(u - v) for u, v in zip(p["bbox"], q["bbox"]))
            conf = abs(p["detection_confidence"] - q["detection_confidence"])
            if box > SERVE_BOX_TOL_PX or conf > SERVE_CONF_TOL:
                raise AssertionError(
                    f"{label} frame {f}: box {box} px, confidence {conf}")


def same_job_results(a: dict, b: dict, label: str) -> None:
    """A job run beside another against the same job run alone."""
    fa, fb = a["results"], b["results"]
    if [f["frame_number"] for f in fa] != [f["frame_number"] for f in fb]:
        raise AssertionError(f"{label}: other frames")
    if [f.get("duplicate_of") for f in fa] != [
            f.get("duplicate_of") for f in fb]:
        raise AssertionError(f"{label}: other keyframes")
    same_frames([f["detections"] for f in fa], [f["detections"] for f in fb],
                label)


def metric_value(text: str, sample: str) -> float:
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"/metrics has no sample {sample}")


def serve_phase(torch, np, card, results, state):
    """The port's REST service on the card: the in-process server with its
    thread worker, driven over HTTP through jobs on the trained
    checkpoints; then ``python -m vtd_tpu_torch serve`` as a process.
    Its clips, logs and outputs live in a directory removed after it."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="vtd_serve_") as tmp:
        run_serve(torch, np, card, results, state, tmp)


def run_serve(torch, np, card, results, state, tmp):
    import asyncio
    import csv
    import datetime
    import io
    import os
    import socket
    import xml.etree.ElementTree as ET

    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.ops.cc_kernels import segmented_cc_round
    from vtd_tpu_torch.serve import tasks
    from vtd_tpu_torch.serve.app import create_app
    from vtd_tpu_torch.serve.http import Server
    from vtd_tpu_torch.serve.queue import task_queue
    from vtd_tpu_torch.serve.services import StorageService

    class NoLimit:  # polling must not meet the 5/min processing limit
        def incr_window(self, key, window_s):
            return 0

    repo = os.path.dirname(os.path.abspath(__file__))
    settings.model_path = os.path.join(repo, "models")
    settings.temp_dir = os.path.join(tmp, "temp")
    settings.output_dir = os.path.join(tmp, "out")
    settings.database_url = "sqlite://"
    settings.device = "cuda"
    clip = os.path.join(tmp, "clip.mp4")
    n_src = write_serve_clip(np, clip)
    n_frames = n_src // int(SERVE_FPS / settings.target_sample_fps)
    content = open(clip, "rb").read()

    t_start = time.perf_counter()
    app = create_app(rate_limit_store=NoLimit(), storage_service=StorageService(
        base_dir=os.path.join(tmp, "uploads")))
    server = Server(app, "127.0.0.1", 0)
    server.start_background()
    api = Api(f"http://127.0.0.1:{server.port}")
    try:
        status, body, _ = wait_ready(api, 60.0)
        ready_s = time.perf_counter() - t_start
        if status != 200:
            raise AssertionError(f"/health/ready {status}: {body[:400]!r}")
        user = {"email": "smoke@example.com", "username": "smoke",
                "password": "pw"}
        api.json("POST", "/api/v1/auth/register", expect=201,
                 data=json.dumps(user).encode(), ctype="application/json")
        tok = api.json("POST", "/api/v1/auth/login", data=(
            b"username=smoke&password=pw"),
            ctype="application/x-www-form-urlencoded")["access_token"]
        api.headers = {"Authorization": f"Bearer {tok}"}
        if api.json("GET", "/api/v1/auth/me")["username"] != "smoke":
            raise AssertionError("/auth/me is not the user")
        # HTTP + JWT check + a user lookup, one request at a time
        rtt = []
        for _ in range(20):
            t0 = time.perf_counter()
            api.json("GET", "/api/v1/auth/me")
            rtt.append(time.perf_counter() - t0)
        http_ms = 1e3 * sorted(rtt)[len(rtt) // 2]
        v1 = api.upload("clip.mp4", content)["id"]
        v2 = api.upload("clip2.mp4", content)["id"]

        reset_counts()
        walls, rows = {}, {}
        for name, vid, query in (
            ("crnn", v1, {"use_transformer": "false"}),
            ("trocr", v1, {"use_transformer": "true"}),
            ("keyframe", v1, {"use_transformer": "false",
                              "sample_mode": "keyframe"}),
        ):
            rows[name], walls[name] = api.wait(*api.detect(vid, **query))
            if name == "crnn":  # the exports of the latest completed job
                csv_text = api.json(
                    "GET", f"/api/v1/processing/videos/{v1}/results",
                    query={"format": "csv"})["content"]
                xml_text = api.json(
                    "GET", f"/api/v1/processing/videos/{v1}/results",
                    query={"format": "xml"})["content"]
                js = api.json("GET",
                              f"/api/v1/processing/videos/{v1}/results")
                status, annotated = api.call(
                    "GET", f"/api/v1/processing/videos/{v1}/annotated")
                if status != 200 or len(annotated) < 1000:
                    raise AssertionError(f"annotated video: HTTP {status}")
        # two jobs back to back: both worker threads, one pipeline
        # singleton, one CUDA stream
        kf2 = api.detect(v1, use_transformer="false", sample_mode="keyframe")
        cr2 = api.detect(v2, use_transformer="false")
        rows["keyframe2"], walls["keyframe2"] = api.wait(*kf2)
        rows["crnn2"], walls["crnn2"] = api.wait(*cr2)
        rows["crnn_warm"], walls["crnn_warm"] = api.wait(
            *api.detect(v2, use_transformer="false"))
        calls = segmented_cc_round.launches
        cuda_calls = segmented_cc_round.cuda_launches
        record_path(results, "serve_path")
        if calls == 0:
            raise AssertionError("no segmented_cc_round launch in the "
                                 "served jobs")

        res = {k: r["result_data"] for k, r in rows.items()}
        n_det = {}
        for name in ("crnn", "trocr", "crnn2", "crnn_warm"):
            n_det[name] = check_served_texts(res[name], name, n_frames)
        for name in ("keyframe", "keyframe2"):
            frames = res[name]["results"]
            dups = [f for f in frames if "duplicate_of" in f]
            if not dups or len(dups) == len(frames):
                raise AssertionError(f"{name}: {len(dups)} duplicates of "
                                     f"{len(frames)} frames")
            n_det[name] = check_served_texts(res[name], name, n_frames)
        same_job_results(res["keyframe"], res["keyframe2"], "keyframe pair")
        same_job_results(res["crnn"], res["crnn2"], "crnn pair")
        n_kf = sum(1 for f in res["keyframe"]["results"]
                   if "duplicate_of" not in f)

        csv_rows = list(csv.reader(io.StringIO(csv_text)))
        if (csv_rows[0][:3] != ["frame_number", "timestamp", "text"]
                or len(csv_rows) - 1 != n_det["crnn"]):
            raise AssertionError(f"csv export: {len(csv_rows) - 1} rows")
        n_xml = len(ET.fromstring(xml_text).findall("frames/frame/object"))
        if n_xml != n_det["crnn"]:
            raise AssertionError(f"xml export: {n_xml} objects")
        if js["summary"]["detected_texts"] != sorted(TRUTH):
            raise AssertionError(f"json results {js['summary']}")

        health = api.json("GET", "/health/detailed")
        acc = health["checks"]["accelerator"]
        if (acc.get("status") != "healthy" or acc.get("probe") != "cuda"
                or acc.get("devices", [None])[0]
                != torch.cuda.get_device_name(0)):
            raise AssertionError(f"CUDA probe: {acc}")
        _, metrics = api.call("GET", "/metrics")
        metrics = metrics.decode()
        n_inf = metric_value(metrics, 'model_inference_duration_seconds_count'
                             '{model_type="DBNet-CRNN"}')
        n_inf_tr = metric_value(metrics, 'model_inference_duration_seconds_'
                                'count{model_type="transformer"}')
        n_occ = metric_value(metrics, "recognizer_chunk_occupancy_count")
        if min(n_inf, n_inf_tr, n_occ) <= 0:
            raise AssertionError("pipeline counters did not count")

        # the same clip straight through process_video on the same
        # pipeline, in this run
        pipe = tasks.get_pipeline(False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct = asyncio.run(pipe.process_video(clip, ""))
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        check_served_texts(direct, "process_video", n_frames)
    finally:
        server.shutdown()
        task_queue.shutdown()

    def at(stamp):
        return datetime.datetime.fromisoformat(stamp).timestamp()

    # from the job row's own stamps (UTC; created_at to the millisecond):
    # queue wait = started_at - created_at; the task around process_video
    # (get_pipeline, the resume file, the DB writes) = completed_at -
    # started_at - process_video's own time
    server_side = {}
    for k, r in rows.items():
        pv = r["result_data"]["summary"]["processing_time_seconds"]
        run = at(r["completed_at"]) - at(r["started_at"])
        server_side[k] = (pv, at(r["started_at"]) - at(r["created_at"]),
                          run - pv)
    print(f"serve: /health/ready answered 200 {ready_s:.3f} s after the "
          f"server was built (in process); GET /auth/me {http_ms:.3f} ms "
          f"(median of 20); "
          f"jobs over HTTP on the trained checkpoints, {n_frames} frames "
          f"each of a {n_src}-frame 640x640 mp4v clip: every frame of the "
          f"CRNN, TrOCR and keyframe jobs reads {sorted(TRUTH)}; keyframe "
          f"jobs shipped {n_kf} keyframes and covered all {n_frames} "
          f"frames; the two jobs run back to back equal their solo runs; "
          f"CSV {len(csv_rows) - 1} rows, XML {n_xml} objects, annotated "
          f"mp4 {len(annotated)} B; CUDA probe {acc['devices']}")
    first = {"crnn": "; the first CRNN job, it builds the pipeline",
             "trocr": "; the first TrOCR job, it builds the pipeline",
             "keyframe2": "; beside crnn2", "crnn2": "; beside keyframe2"}
    for name, wall in walls.items():
        pv, queued, around = server_side[name]
        print(f"serve job {name}: {wall * 1e3:.3f} ms from POST detect to "
              f"'completed' (queued {queued * 1e3:.3f} ms, process_video "
              f"{pv * 1e3:.3f} ms, the task around it {around * 1e3:.3f} ms"
              f"{first.get(name, '')}), {n_frames / wall:.3f} frames/s "
              f"through the service ({card})")
    state["serve_warm_crnn_s"] = walls["crnn_warm"]
    print(f"serve: the same clip straight through process_video "
          f"{direct_s * 1e3:.3f} ms, {n_frames / direct_s:.3f} frames/s; "
          f"warm CRNN job through the service "
          f"{n_frames / walls['crnn_warm']:.3f} frames/s ({card})")
    print(f"serve path: segmented_cc_round {calls} calls ({cuda_calls} CUDA "
          f"launches) over the 6 jobs; /metrics counts "
          f"{n_inf:.0f} CRNN and {n_inf_tr:.0f} TrOCR inference batches, "
          f"{n_occ:.0f} recognizer chunks (the registry is the process's: "
          f"every phase's pipelines count)")

    # python -m vtd_tpu_torch serve, as a process, until it is ready
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, DATABASE_URL="sqlite://",
               TEMP_DIR=os.path.join(tmp, "p_temp"),
               OUTPUT_DIR=os.path.join(tmp, "p_out"),
               MODEL_PATH=settings.model_path)
    log = open(os.path.join(tmp, "serve.log"), "wb")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vtd_tpu_torch", "serve", "--host",
         "127.0.0.1", "--port", str(port)],
        cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        status, body, _ = wait_ready(Api(f"http://127.0.0.1:{port}"), 90.0)
        proc_ready_s = time.perf_counter() - t0
        if status != 200:
            raise AssertionError(f"serve process /health/ready {status}: "
                                 f"{body[:400]!r}")
    except BaseException:
        proc.kill()
        proc.wait(timeout=30)
        log.close()
        print(open(os.path.join(tmp, "serve.log"), "rb").read()[-3000:]
              .decode(errors="replace"), file=sys.stderr)
        raise
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
    log.close()
    print(f"serve: `python -m vtd_tpu_torch serve` answered /health/ready "
          f"200 {proc_ready_s:.3f} s after it was started (interpreter, "
          f"torch import, CUDA probe), then stopped ({card})")


FLEET_LONG_SECONDS = 15  # the job cancelled mid-run: 150 sampled frames


class CountingVideoTask:
    """The service's ``process_video_task`` as a ``worker`` process or a
    pool child runs it (``worker_main`` / ``TaskQueue(tasks_module=
    "chip_smoke")`` find it by its ``name`` and ``fn``): its return gains
    the pid and both kernels' counts around the job, which live in that
    process, not in this one."""

    name = "process_video_task"

    @staticmethod
    def fn(task, video_id, config):
        import os

        from vtd_tpu_torch.ops.cc_kernels import (
            neighbor_min_sweeps, segmented_cc_round,
        )
        from vtd_tpu_torch.serve.tasks import process_video_task

        counters = (segmented_cc_round, neighbor_min_sweeps)
        before = [(k.launches, k.cuda_launches) for k in counters]
        out = process_video_task.fn(task, video_id, config)
        seg, sweeps = [(k.launches - a, k.cuda_launches - b)
                       for k, (a, b) in zip(counters, before)]
        return dict(out, pid=os.getpid(),
                    segmented_calls=seg[0], segmented_cuda_launches=seg[1],
                    sweeps_calls=sweeps[0], sweeps_cuda_launches=sweeps[1])


PROCESS_VIDEO_TASK = CountingVideoTask()

# ``python -c WORKER_CODE <worker arguments>``, from the repo's root
WORKER_CODE = "import sys, chip_smoke; sys.exit(chip_smoke.worker_main())"


def worker_main() -> int:
    """``python -m vtd_tpu_torch worker`` with this file's
    ``PROCESS_VIDEO_TASK`` in place of the service's task of that name."""
    from vtd_tpu_torch.__main__ import main
    from vtd_tpu_torch.serve import tasks  # noqa: F401  registered first
    from vtd_tpu_torch.serve.queue import task_queue

    task_queue.tasks[PROCESS_VIDEO_TASK.name] = PROCESS_VIDEO_TASK
    return main(["worker", *sys.argv[1:]])


def pid_alive(pid: int) -> bool:
    import os

    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def wait_until(pred, what: str, deadline_s: float = JOB_DEADLINE_S):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError(f"{what}: not within {deadline_s} s")
        time.sleep(0.02)


def fleet_phase(torch, np, card, results, state):
    """The serving fleet on the card: ``brokerd`` and a ``worker`` process
    behind the port's ``Server``, then the process pool whose children
    each own a CUDA context, then the profiler's trace. Its clips, logs,
    database and traces live in a directory removed after it."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="vtd_fleet_") as tmp:
        run_fleet(torch, np, card, results, state, tmp)


def run_fleet(torch, np, card, results, state, tmp):
    import asyncio
    import datetime
    import glob
    import multiprocessing
    import os
    import re
    import statistics
    import urllib.request

    from vtd_tpu_torch.core.config import settings
    from vtd_tpu_torch.frontend.client import APIClient
    from vtd_tpu_torch.runtime import VideoTextPipeline
    from vtd_tpu_torch.serve.app import create_app
    from vtd_tpu_torch.serve.brokerd import TcpBroker
    from vtd_tpu_torch.serve.db import database
    from vtd_tpu_torch.serve.http import Server
    from vtd_tpu_torch.serve.queue import AsyncResult, task_queue
    from vtd_tpu_torch.serve.services import StorageService

    class NoLimit:  # polling must not meet the 5/min processing limit
        def incr_window(self, key, window_s):
            return 0

    # the service and the broker are on 127.0.0.1: no proxy for urllib
    urllib.request.install_opener(
        urllib.request.build_opener(urllib.request.ProxyHandler({})))
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {"DATABASE_URL": f"sqlite:///{tmp}/vtd.db",
           "TEMP_DIR": os.path.join(tmp, "temp"),
           "OUTPUT_DIR": os.path.join(tmp, "out"),
           "MODEL_PATH": os.path.join(repo, "models"), "DEVICE": "cuda"}
    os.environ.update(env)  # pool children read their settings from it
    for k, v in env.items():
        setattr(settings, k.lower(), v)
    database.get_database(env["DATABASE_URL"])
    clip = os.path.join(tmp, "clip.mp4")
    n_src = write_serve_clip(np, clip)
    n_frames = n_src // int(SERVE_FPS / settings.target_sample_fps)
    long_clip = os.path.join(tmp, "long.mp4")
    import cv2

    frame = verify_frames(np)["frame_bgr"]
    writer = cv2.VideoWriter(long_clip, cv2.VideoWriter_fourcc(*"mp4v"),
                             SERVE_FPS, (640, 640))
    for _ in range(int(SERVE_FPS * FLEET_LONG_SECONDS)):
        writer.write(frame)
    writer.release()

    procs, logs = {}, {}

    def start(name, args):
        logs[name] = os.path.join(tmp, f"{name}.log")
        with open(logs[name], "wb") as fh:
            procs[name] = (subprocess.Popen(
                [sys.executable, *args], cwd=repo, env=dict(os.environ),
                stdout=fh, stderr=subprocess.STDOUT), time.time())

    def tail(name):
        return open(logs[name], errors="replace").read()[-3000:]

    def job_times(row):
        def at(stamp):
            return datetime.datetime.fromisoformat(stamp).replace(
                tzinfo=datetime.timezone.utc).timestamp()
        return at(row["started_at"]), at(row["completed_at"])

    server = None
    rows, walls, counts = {}, {}, {}
    try:
        # -- brokerd + one worker process, the API drains nothing ------
        start("brokerd", ["-m", "vtd_tpu_torch", "brokerd", "--host",
                          "127.0.0.1", "--port", "0"])
        m = None
        t0 = time.perf_counter()
        while m is None:
            m = re.search(r"listening on 127\.0\.0\.1:(\d+)",
                          open(logs["brokerd"]).read())
            if procs["brokerd"][0].poll() is not None or \
                    time.perf_counter() - t0 > 60:
                raise AssertionError(f"brokerd: {tail('brokerd')}")
            time.sleep(0.02)
        broker_url = f"tcp://127.0.0.1:{m[1]}"
        broker = TcpBroker("127.0.0.1", int(m[1]), worker_id="smoke")
        rtt = []
        for _ in range(50):
            t0 = time.perf_counter()
            if not broker.ping():
                raise AssertionError("brokerd did not answer ping")
            rtt.append(time.perf_counter() - t0)
        rpc_ms = 1e3 * statistics.median(rtt)
        if task_queue.stats()["workers"]:
            raise AssertionError("thread workers still drain this queue")
        task_queue.broker = broker
        task_queue.concurrency = 0
        server = Server(create_app(
            start_worker=False, rate_limit_store=NoLimit(),
            storage_service=StorageService(
                base_dir=os.path.join(tmp, "uploads"))), "127.0.0.1", 0)
        server.start_background()
        api = APIClient(f"http://127.0.0.1:{server.port}", timeout=60.0)
        if not (api.register("fleet@example.com", "fleet", "pw")
                and api.login("fleet", "pw")):
            raise AssertionError("register / login failed")
        content = open(clip, "rb").read()
        v1 = api.upload_video("clip.mp4", content)["id"]
        v2 = api.upload_video("clip2.mp4", content)["id"]
        v3 = api.upload_video("long.mp4", open(long_clip, "rb").read())["id"]

        def run(label, video_id, transformer=False):
            t0 = time.perf_counter()
            job = api.start_processing(video_id, use_transformer=transformer)
            if job is None:
                raise AssertionError(f"{label}: detect refused")
            return label, job, t0

        def finish(label, job, t0):
            """Wait for the job row to read 'completed'; keep the row and
            the task's return (pid and kernel counts of its process)."""
            st = api.wait_for_job(job["id"], timeout=JOB_DEADLINE_S,
                                  poll=0.02)
            walls[label] = time.perf_counter() - t0
            if st is None or st["status"] != "completed":
                raise AssertionError(f"{label}: {st}")
            rows[label] = api._request(
                "GET", f"/api/v1/processing/jobs/{job['id']}")[1]
            # the task returns just after it writes 'completed'
            counts[label] = AsyncResult(job["celery_task_id"],
                                        task_queue).get(JOB_DEADLINE_S)

        # the first job waits in the queue before the worker starts: its
        # start is the worker's time to its first claim
        first = run("tcp_crnn", v1)
        start("worker", ["-c", WORKER_CODE, "--broker", broker_url,
                         "--concurrency", "1"])
        finish(*first)
        for label, video_id, transformer in (
                ("tcp_trocr", v1, True), ("tcp_crnn_warm", v2, False)):
            finish(*run(label, video_id, transformer))
            if procs["worker"][0].poll() is not None:
                raise AssertionError(f"worker died: {tail('worker')}")
        worker_pid = counts["tcp_crnn"]["pid"]
        first_claim_s = job_times(rows["tcp_crnn"])[0] - procs["worker"][1]
        if {c["pid"] for k, c in counts.items()} != {worker_pid} or \
                worker_pid == os.getpid():
            raise AssertionError(f"jobs did not run in the worker: {counts}")

        # -- the process pool: children with their own CUDA contexts ---
        task_queue.broker = None
        task_queue.worker_kind = "process"
        task_queue.tasks_module = "chip_smoke"
        task_queue.concurrency = 2
        task_queue.max_tasks_per_child = 2
        t_pool = time.time()
        for j in [run("pool_a", v1), run("pool_b", v2)]:
            finish(*j)
        spawn_to_started_s = min(job_times(rows[k])[0]
                                 for k in ("pool_a", "pool_b")) - t_pool
        first_pids = {counts[k]["pid"] for k in ("pool_a", "pool_b")}
        if len(first_pids) != 2 or os.getpid() in first_pids:
            raise AssertionError(f"the pair ran in {first_pids}")
        for k in ("pool_a", "pool_b"):
            same_job_results(rows["tcp_crnn"]["result_data"],
                             rows[k]["result_data"], f"{k} against tcp")
        # a job on the long clip, killed once it is running on the card
        label, job, _ = run("pool_long", v3)
        wait_until(lambda: ((api.get_job_status(job["id"]) or {}).get(
            "processed_frames") or 0) > 0, "the long job's first batch")
        rec = task_queue.records[job["celery_task_id"]]
        t_kill = time.time()
        if not api.cancel_job(job["id"]):
            raise AssertionError("cancel refused")
        st = api.get_job_status(job["id"])
        if st["status"] != "cancelled" or rec.state != "REVOKED":
            raise AssertionError(f"cancelled job: {st}, {rec.state}")
        killed = [p for p in first_pids if not pid_alive(p)]
        if len(killed) != 1:
            raise AssertionError(f"no child was killed: {first_pids}")
        # both children busy: the respawned one must take a job
        for j in [run("pool_c", v1), run("pool_d", v2)]:
            finish(*j)
        pids2 = {counts[k]["pid"] for k in ("pool_c", "pool_d")}
        fresh = pids2 - first_pids
        if len(fresh) != 1:
            raise AssertionError(f"no respawned child ran: {pids2}")
        (fresh_pid,) = fresh
        fresh_label = next(k for k in ("pool_c", "pool_d")
                           if counts[k]["pid"] == fresh_pid)
        kill_to_ready_s = job_times(rows[fresh_label])[0] - t_kill
        (survivor,) = first_pids - set(killed)
        # the survivor ran its 2nd job: max_tasks_per_child recycles it
        wait_until(lambda: not pid_alive(survivor), "the recycle")
        finish(*run("pool_warm", v1))
        warm_pid = counts["pool_warm"]["pid"]
        pool_warm_is_warm = warm_pid == fresh_pid
        for k in ("pool_c", "pool_d", "pool_warm"):
            check_served_texts(rows[k]["result_data"], k, n_frames)
        for k in ("tcp_crnn", "tcp_trocr", "tcp_crnn_warm"):
            check_served_texts(rows[k]["result_data"], k, n_frames)
    finally:
        if server is not None:
            server.shutdown()
        task_queue.shutdown()
        for name, (proc, _) in procs.items():
            if proc.poll() is None:
                proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    calls, cuda, sweeps, sweeps_cuda = (
        sum(c[key] for c in counts.values())
        for key in ("segmented_calls", "segmented_cuda_launches",
                    "sweeps_calls", "sweeps_cuda_launches"))
    per_job = {k: c["segmented_calls"] for k, c in counts.items()}
    if min(per_job.values()) <= 0:
        raise AssertionError(f"a fleet job launched no segmented_cc_round: "
                             f"{per_job}")
    record_launches(results, "segmented_cc_round", "launches_fleet_path",
                    calls)
    record_launches(results, "segmented_cc_round", "cuda_launches_fleet_path",
                    cuda)
    record_launches(results, "neighbor_min_sweeps", "launches_fleet_path",
                    sweeps)
    record_launches(results, "neighbor_min_sweeps",
                    "cuda_launches_fleet_path", sweeps_cuda)

    print(f"fleet: brokerd RPC round trip {rpc_ms:.3f} ms (ping, median of "
          f"50); worker process start to its first claim (a job pending "
          f"before it started) {first_claim_s:.3f} s; pool child spawn to its first job "
          f"started {spawn_to_started_s:.3f} s; kill to the respawned "
          f"child's first job started {kill_to_ready_s:.3f} s ({card})")
    serve_warm = state.get("serve_warm_crnn_s")
    for label in ("tcp_crnn", "tcp_trocr", "tcp_crnn_warm", "pool_a",
                  "pool_b", "pool_c", "pool_d", "pool_warm"):
        pv = rows[label]["result_data"]["summary"]["processing_time_seconds"]
        started, done = job_times(rows[label])
        print(f"fleet job {label}: {walls[label] * 1e3:.3f} ms from POST "
              f"detect to 'completed' (process_video {pv * 1e3:.3f} ms, "
              f"task {(done - started) * 1e3:.3f} ms), pid "
              f"{counts[label]['pid']}, segmented_cc_round "
              f"{counts[label]['segmented_calls']} calls "
              f"({counts[label]['segmented_cuda_launches']} CUDA launches) "
              f"counted in that process ({card})")
    print(f"fleet: warm CRNN job POST to 'completed' through tcp:// "
          f"{walls['tcp_crnn_warm'] * 1e3:.3f} ms, through the pool "
          f"{walls['pool_warm'] * 1e3:.3f} ms"
          f"{'' if pool_warm_is_warm else ' (landed on a cold child)'}, "
          f"thread worker (serve phase, this run) "
          + (f"{serve_warm * 1e3:.3f} ms" if serve_warm else "not run")
          + f" ({card})")
    print(f"fleet path: segmented_cc_round {calls} calls ({cuda} CUDA "
          f"launches), neighbor_min_sweeps {sweeps} calls ({sweeps_cuda} "
          f"CUDA launches) over {len(counts)} completed jobs, counted in the "
          f"worker process and the pool children; the cancelled job's "
          f"child was SIGKILLed mid-video (pid {killed[0]}), the child "
          f"that ran its 2nd job was recycled (pid {survivor}), the "
          f"respawned child (pid {fresh_pid}) completed on the card")
    left = [p.pid for p, _ in procs.values() if p.poll() is None]
    left += [c.pid for c in multiprocessing.active_children()]
    left += sorted({c["pid"] for c in counts.values() if pid_alive(c["pid"])})
    if left:
        raise AssertionError(f"processes left running: {left}")
    print("fleet: no worker or pool child left running")

    # -- the profiler's trace of one process_video on the card ----------
    pipe = VideoTextPipeline(
        detector_path=os.path.join(repo, CHECKPOINTS["detector"]),
        recognizer_path=os.path.join(repo, CHECKPOINTS["crnn"]),
        use_transformer_ocr=False,
        device="cuda")
    trace_dir = os.path.join(tmp, "trace")
    asyncio.run(pipe.process_video(clip, ""))  # warm
    times, outs = {}, {}
    # the first traced call also starts the profiler (CUPTI) in this
    # process; the second is the steady cost
    for name in ("plain", "traced", "traced2", "plain2"):
        pipe.profile_dir = trace_dir if name.startswith("traced") else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = asyncio.run(pipe.process_video(clip, ""))
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(trace_dir, "process_video-*.json")))
    if len(paths) != 2:
        raise AssertionError(f"traces: {paths}")
    events = json.load(open(paths[-1]))["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    ours = [k for k in kernels if "strip_kernel" in k or "diag_kernel" in k]
    cudnn = [k for k in kernels if "cublas" not in k.lower() and re.search(
        r"cudnn|fprop|conv", k, re.I)]
    if len(ours) != 2 or not cudnn:
        raise AssertionError(f"the trace misses the card's kernels: "
                             f"{kernels}")
    for name in ("traced", "traced2", "plain2"):
        same_job_results(outs["plain"], outs[name], f"profiler {name}")
    check_served_texts(outs["traced2"], "traced process_video", n_frames)
    print(f"fleet profiler: process_video {times['plain'] * 1e3:.3f} / "
          f"{times['plain2'] * 1e3:.3f} ms without the profiler, "
          f"{times['traced'] * 1e3:.3f} ms with it (the process's first "
          f"trace) and {times['traced2'] * 1e3:.3f} ms (its second); "
          f"traces {[os.path.getsize(p) for p in paths]} B, the second "
          f"{len(events)} events, {len(kernels)} kernel names, among them "
          f"{[re.search(r'(strip|diag)_kernel', k)[0] for k in ours]} and "
          f"{len(cudnn)} of cuDNN's convolutions, e.g. {cudnn[:2]}; "
          f"results equal ({card})")


DP_STEPS = 6  # timed data-parallel DBNet steps after the compared one
DP_BATCH = 8  # global batch of the data-parallel DBNet steps
# one data-parallel DBNet step in true float32 (TF32 off) on the card
# against the one-process step from the same weights and batch: the
# tolerances the card's train step has held against the CPU's
DP_LOSS_RTOL = 7.3e-05
DP_NORM_RTOL = 1.3e-03


def dp_inputs(torch, rows=slice(None)):
    """``rows`` of the global batch of ``DP_BATCH`` synthetic 640x640
    frames and their maps, on the card."""
    from vtd_tpu_torch.train.train_detector import synthesize_detection_data

    imgs, tgts = synthesize_detection_data(DP_BATCH, 640, seed=0)
    return (torch.from_numpy(imgs[rows]).cuda(),
            {k: torch.from_numpy(v[rows]).cuda() for k, v in tgts.items()})


def dp_first_step(torch, x, t, group, tf32: bool, row=None):
    """A fresh train state from the trained detector's weights (split over
    the mesh ``row`` when one is given) and one step (TF32 convolutions on
    or off) -> (step, its loss and gradient norm)."""
    from vtd_tpu_torch.convert import dbnet_from_jax
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.train.checkpoint import load_weights
    from vtd_tpu_torch.train.trainer import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = tf32
    st = create_train_state(
        DBNet(dtype=torch.float32),
        weights=load_weights(CHECKPOINTS["detector"], dbnet_from_jax),
        device="cuda", row=row)
    step = make_train_step(st["model"], st["optimizer"], group)
    loss = float(step(x, t)["loss"])
    return step, st["model"], {"loss": loss,
                               "grad_norm": grad_norm(torch, st["model"])}


def dp_step_rank(rank: int, n_steps: int) -> dict:
    """One rank of the data-parallel DBNet run (spawned by
    ``spawn_ranks``), on its slice of the global batch: the first step in
    true float32 and with TF32 convolutions (loss, gradient norm), then
    ``n_steps`` timed TF32 steps and as many timed gradient all-reduces."""
    import torch
    import torch.distributed as dist

    from vtd_tpu_torch.core.mesh import local_batch_slice, make_mesh
    from vtd_tpu_torch.parallel.collectives import average_gradients

    world = dist.get_world_size()
    group = dist.group.WORLD
    start, size = local_batch_slice(
        DP_BATCH, make_mesh(n_data=world, devices=["cuda"] * world))
    x, t = dp_inputs(torch, slice(start, start + size))
    out = {"backend": dist.get_backend(), "rows": [start, size]}
    out["fp32"] = dp_first_step(torch, x, t, group, tf32=False)[2]
    step, model, out["tf32"] = dp_first_step(torch, x, t, group, tf32=True)
    out["ms"], _ = timed_steps(torch, lambda: step(x, t)["loss"], n_steps)
    reduce_ms = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average_gradients(model.parameters(), group)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = reduce_ms
    out["grad_bytes"] = 4 * sum(p.numel() for p in model.parameters())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def parallel_phase(torch, np, card, results, state):
    """Several devices: data-parallel inference over a mesh of replicas,
    the two-stage runner, and data-parallel DBNet training, on the
    trained checkpoints at config 3's shape; with one card, replicas and
    ranks share it."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="vtd_parallel_") as tmp:
        run_parallel(torch, np, card, results, state, tmp)


def run_parallel(torch, np, card, results, state, tmp):
    import multiprocessing

    from vtd_tpu_torch.core.mesh import make_mesh, spawn_ranks
    from vtd_tpu_torch.ops.cc_kernels import segmented_cc_round
    from vtd_tpu_torch.parallel.pipeline import TwoStagePipeline
    from vtd_tpu_torch.runtime import TextDetector, VideoTextPipeline
    from vtd_tpu_torch.train.train_detector import main as train_detector_main

    n_cards = torch.cuda.device_count()
    ref = verify_frames(np)
    frames = np.stack([ref["frame_i420"]] * B)
    valid = np.ones(B, bool)
    plan = [(frames, valid, None)] * N_BATCHES
    fused = trained_pipeline(state, "crnn")

    def mesh_pipeline(devices):
        return VideoTextPipeline(
            detector_path=CHECKPOINTS["detector"],
            recognizer_path=CHECKPOINTS["crnn"], use_transformer_ocr=False,
            batch_size=B, max_dets=64, host_downscale=640,
            transfer_format="yuv420",
            mesh=make_mesh(n_data=len(devices), devices=devices))

    # -- data-parallel inference ----------------------------------------
    meshes = {"mesh1": ["cuda:0"], "parallel": ["cuda:0", "cuda:0"]}
    if n_cards >= 2:
        meshes["cards"] = [f"cuda:{i}" for i in range(n_cards)]
    else:
        print("mesh over distinct cards: not run (one card visible)")
    want = None
    rates = {}
    for path, devices in [("fused", None)] + list(meshes.items()):
        pipe = fused if devices is None else mesh_pipeline(devices)
        try:
            pipe.process_batch(frames, valid)  # warm-up
            reset_counts()
            outs, elapsed = run_pipelined(torch, pipe, plan)
            calls, cuda = (segmented_cc_round.launches,
                           segmented_cc_round.cuda_launches)
            if devices is not None:
                record_path(results, f"{path}_path")
        finally:
            if pipe is not fused:
                pipe.close()
        if want is None:
            want = outs
        for k, o in enumerate(outs):
            check_against_reference(o, ref, "crnn")
            same_frames(o, want[k], f"{path} batch {k}")
        n_rep = 1 if devices is None else len(devices)
        if calls != 3 * n_rep * N_BATCHES:
            raise AssertionError(
                f"{path}: {calls} segmented_cc_round calls over {N_BATCHES} "
                f"batches, expected {3 * n_rep * N_BATCHES}")
        rates[path] = B * N_BATCHES / elapsed
        print(f"data-parallel {path} ({devices or 'no mesh'}): "
              f"{N_BATCHES} pipelined batches x {B} frames read "
              f"{sorted(TRUTH)} on every frame, equal to the fused path; "
              f"{calls} segmented_cc_round calls ({cuda} CUDA launches), "
              f"{calls / N_BATCHES:g} = {cuda / N_BATCHES:g} a batch; "
              f"{rates[path]:.3f} frames/s pipelined ({card})")

    # -- two-stage runner ---------------------------------------------------
    runner = TwoStagePipeline(
        fused.detector, fused.recognizer, devices=["cuda:0", "cuda:0"],
        max_dets=64, crop_hw=fused.crop_hw, max_box_frac=fused.max_box_frac)
    try:
        runner.run_batches([frames], 0.5)  # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wires = runner.run_batches([frames] * N_BATCHES, 0.5)
        elapsed = time.perf_counter() - t0
        calls, cuda = record_path(results, "two_stage_path")
        if calls != 3 * N_BATCHES:
            raise AssertionError(f"two-stage: {calls} segmented_cc_round "
                                 f"calls over {N_BATCHES} batches")
        for k, (pack,) in enumerate(wires):
            if pack.shape[:2] != (B, 64) or pack.dtype != np.uint8:
                raise AssertionError(f"two-stage wire {pack.shape}")
            out = fused.process_batch(
                frames, valid, handles={"shards": [{
                    "pack": torch.from_numpy(pack), "event": None,
                    "crops": None}], "replicas": [None]})
            same_frames(out, want[k], f"two-stage batch {k}")
        print(f"two-stage runner on {runner.stage_devices()}: "
              f"{N_BATCHES} batches x {B} frames through run_batches equal "
              f"to the fused path; {calls} segmented_cc_round calls ({cuda} "
              f"CUDA launches); {B * N_BATCHES / elapsed:.3f} frames/s "
              f"against {rates['fused']:.3f} fused ({card})")
    finally:
        runner.close()
    trocr = trained_pipeline(state, "trocr")
    runner = TwoStagePipeline(
        trocr.detector, trocr.recognizer, use_transformer=True,
        devices=["cuda:0", "cuda:0"], max_dets=64, crop_hw=trocr.crop_hw,
        max_box_frac=trocr.max_box_frac)
    try:
        want_tr = trocr.process_batch(frames, valid)
        got_tr = trocr.process_batch(frames, valid,
                                     handles=runner.dispatch(frames, 0.5))
        same_frames(got_tr, want_tr, "two-stage TrOCR")
        check_against_reference(got_tr, ref, "trocr")
        print(f"two-stage runner, TrOCR: one batch of {B} reads "
              f"{sorted(TRUTH)} on every frame, as the fused TrOCR path")
    finally:
        runner.close()
    if n_cards >= 2:
        two = VideoTextPipeline(
            detector_path=CHECKPOINTS["detector"],
            recognizer_path=CHECKPOINTS["crnn"], use_transformer_ocr=False,
            batch_size=B, max_dets=64, host_downscale=640,
            transfer_format="yuv420", parallel_mode="two_stage")
        try:
            same_frames(two.process_batch(frames, valid), want[0],
                        "two-stage on distinct cards")
        finally:
            two.close()
        print(f"two-stage on distinct cards {two._two_stage.stage_devices()}"
              f": equal to the fused path")
    else:
        print("two-stage on distinct cards: not run (one card visible)")

    # -- data-parallel DBNet training ---------------------------------------
    res = train_detector_main([
        "--synthetic", "--n-samples", "20", "--image-size", "160",
        "--epochs", "1", "--batch-size", "8", "--mesh", "1x1",
        "--device", "cuda", "--checkpoint-dir", f"{tmp}/dbnet"])
    if res.get("status") != "success":
        raise AssertionError(f"train-detector --mesh 1x1: {res}")
    det = TextDetector(model_path=res["best_model_path"], input_size=160,
                       device="cuda")
    with torch.inference_mode():
        prob = det.probability(torch.zeros(2, 160, 160, 3, dtype=torch.uint8,
                                           device="cuda"))
    if not torch.isfinite(prob).all():
        raise AssertionError("the --mesh 1x1 checkpoint gives non-finite maps")
    print(f"train-detector --mesh 1x1 --device cuda: one spawned NCCL rank, "
          f"status success, val_loss {res['best_val_loss']:.4f}, checkpoint "
          f"read by TextDetector")
    del det, prob

    tf32_was = torch.backends.cudnn.allow_tf32
    x, t = dp_inputs(torch)
    one = {"fp32": dp_first_step(torch, x, t, None, tf32=False)[2]}
    again = dp_first_step(torch, x, t, None, tf32=True)[2]
    step, model, one["tf32"] = dp_first_step(torch, x, t, None, tf32=True)
    one_ms, _ = timed_steps(torch, lambda: step(x, t)["loss"], DP_STEPS)
    torch.backends.cudnn.allow_tf32 = tf32_was
    del step, model, x, t
    gc.collect()
    torch.cuda.empty_cache()
    runs = {"nccl x1": spawn_ranks(dp_step_rank, (DP_STEPS,), 1,
                                   device="cuda")}
    if n_cards >= 2:
        runs[f"nccl x{n_cards}"] = spawn_ranks(
            dp_step_rank, (DP_STEPS,), n_cards, device="cuda")
    else:
        print("NCCL over distinct cards: not run (one card visible)")
    runs["gloo x2 on cuda:0"] = spawn_ranks(
        dp_step_rank, (DP_STEPS,), 2, device="cuda", backend="gloo")

    def rel(a, b, key):
        return abs(a[key] - b[key]) / abs(b[key])

    print(f"DBNet 640x640 global batch {DP_BATCH} float32 from "
          f"{CHECKPOINTS['detector']}, one process: "
          f"{float(np.median(one_ms)):.3f} ms/step with TF32 convolutions "
          f"(median of {DP_STEPS}, CUDA events); a second one-process first "
          f"step: loss rel {rel(again, one['tf32'], 'loss'):.2e}, gradient "
          f"norm rel {rel(again, one['tf32'], 'grad_norm'):.2e} ({card})")
    for name, ranks in runs.items():
        r0 = ranks[0]
        if any(r[k] != r0[k] for r in ranks for k in ("fp32", "tf32")):
            raise AssertionError(f"{name}: the ranks disagree: {ranks}")
        dl = rel(r0["fp32"], one["fp32"], "loss")
        dn = rel(r0["fp32"], one["fp32"], "grad_norm")
        if not (dl <= DP_LOSS_RTOL and dn <= DP_NORM_RTOL):
            raise AssertionError(
                f"{name}: float32 loss rel {dl:.2e}, gradient norm rel "
                f"{dn:.2e} off the one-process step")
        ms = float(np.median([m for r in ranks for m in r["ms"]]))
        red = float(np.median([m for r in ranks for m in r["allreduce_ms"]]))
        print(f"DBNet data-parallel {name} ({r0['backend']}, rows "
              f"{[r['rows'] for r in ranks]}): true float32 first step "
              f"against the one process's: loss rel {dl:.2e} (allowed "
              f"{DP_LOSS_RTOL:g}), gradient norm rel {dn:.2e} (allowed "
              f"{DP_NORM_RTOL:g}); with TF32: loss rel "
              f"{rel(r0['tf32'], one['tf32'], 'loss'):.2e}, gradient norm "
              f"rel {rel(r0['tf32'], one['tf32'], 'grad_norm'):.2e}; "
              f"{ms:.3f} ms/step (TF32), gradient all-reduce of "
              f"{r0['grad_bytes'] / 1e6:.1f} MB {red:.3f} ms (medians over "
              f"ranks and {DP_STEPS} steps); peak "
              f"{max(r['peak_gib'] for r in ranks):.2f} GiB a rank ({card})")
    left = multiprocessing.active_children()
    if left or torch.distributed.is_initialized():
        raise AssertionError(f"ranks left running: {left}")
    print("parallel phase: every spawned rank joined, no process group left")


# the app-layout detector (seeded weights, bf16 on the card) against the
# same file in float32 on the CPU, on the verify frame's probability map;
# both on one x86 CPU, bf16 against float32 gave 0.0485 max, 0.0040 mean
# (tests/torch_app_layout.py's seed 0)
APP_PROB_MAX_TOL = 0.1
APP_PROB_MEAN_TOL = 0.01
# the trained detector against itself after save_model / load_model: the
# same weights and kernels on the same card
ROUND_TRIP_PROB_TOL = 1e-3
HOSTAPI_FRAME = 3  # a frame of the serve clip's first half: the verify frame


def median_load_ms(torch, fn, runs: int = 3) -> float:
    """Median host ms of ``fn()`` (a load or a save) with the card
    synchronised after it."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def hostapi_phase(torch, np, card, results, state):
    """The rest of the reference's host API on the card: a DBNet ``.pth``
    in the original app's layout, ``save_model`` / ``load_model``, random
    access to a frame through ``extract_single_frame`` into
    ``process_single_frame``, the result schemas of a ``process_video``
    result, and ``start_metrics_server``. Its files live in a directory
    removed after it."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="vtd_hostapi_") as tmp:
        run_hostapi(torch, np, card, results, state, tmp)


def run_hostapi(torch, np, card, results, state, tmp):
    import asyncio
    import os
    import urllib.request

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_app_layout import write_app_dbnet
    from vtd_tpu_torch.convert import dbnet_from_app_state
    from vtd_tpu_torch.core import FrameResult, RecognizedRegion, VideoResult
    from vtd_tpu_torch.obs import metrics
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps
    from vtd_tpu_torch.runtime.detector import TextDetector
    from vtd_tpu_torch.video import VideoProcessor

    frame = verify_frames(np)["frame_bgr"]

    def prob(det):
        with torch.inference_mode():
            x = torch.from_numpy(frame[None]).to(det.device)
            return det.probability(x).float().cpu()

    # the app's layout: every backbone and head tensor on the card is the
    # converter's, and the map agrees with the same file on the CPU
    app = os.path.join(tmp, "dbnet_app.pth")
    want = dbnet_from_app_state(write_app_dbnet(app, seed=0))
    det = TextDetector(model_path=app, device="cuda")
    loaded = det.load_model(app)
    model_sd = det.model.state_dict()
    for k, v in want.items():
        if loaded[k].device.type != "cuda" or not torch.equal(
                loaded[k].cpu(), v):
            raise AssertionError(f"app layout: load_model's {k} differs")
        if not torch.equal(model_sd[k].cpu(), v.to(model_sd[k].dtype)):
            raise AssertionError(f"app layout: the model's {k} differs")
    p_card, p_cpu = prob(det), prob(TextDetector(model_path=app,
                                                 device="cpu"))
    err = (p_card - p_cpu).abs()
    if not (err.max() <= APP_PROB_MAX_TOL and err.mean() <= APP_PROB_MEAN_TOL):
        raise AssertionError(
            f"app layout: card (bf16) against CPU (float32) map off by "
            f"{float(err.max())} max, {float(err.mean())} mean")
    print(f"hostapi app layout: {len(want)} backbone and head tensors on "
          f"the card bit-equal to dbnet_from_app_state (the model's at "
          f"{det.dtype}); verify-frame map card bf16 against CPU float32: "
          f"{float(err.max()):.5f} max (allowed {APP_PROB_MAX_TOL}), "
          f"{float(err.mean()):.5f} mean (allowed {APP_PROB_MEAN_TOL})")

    # save_model / load_model round trip under a name with no torch suffix
    trained = TextDetector(model_path=CHECKPOINTS["detector"], device="cuda")
    path = os.path.join(tmp, "detector_weights")
    ms_save = median_load_ms(torch, lambda: trained.save_model(path))
    back = TextDetector(model_path=path, device="cuda")
    for k, v in trained.model.state_dict().items():
        if not torch.equal(back.model.state_dict()[k], v):
            raise AssertionError(f"round trip: {k} differs")
    rt = float((prob(back) - prob(trained)).abs().max())
    if rt > ROUND_TRIP_PROB_TOL:
        raise AssertionError(f"round trip: maps differ by {rt}")
    ms = {name: median_load_ms(torch, lambda p=p: trained.load_model(p))
          for name, p in (("orbax directory", CHECKPOINTS["detector"]),
                          ("app .pth", app), ("port torch file", path))}
    print(f"hostapi save_model -> load_model (no .pt suffix): state dict "
          f"bit-equal, maps within {rt} (allowed {ROUND_TRIP_PROB_TOL}); "
          f"load_model ms (median of 3): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
          + f"; save_model {ms_save:.1f} ms ({card})")

    # random access to one frame, read by the trained CRNN pipeline
    clip = os.path.join(tmp, "clip.mp4")
    write_serve_clip(np, clip)
    one = VideoProcessor().extract_single_frame(clip, HOSTAPI_FRAME)
    if one is None or one.shape != (640, 640, 3):
        raise AssertionError(f"extract_single_frame gave {one!r:.80}")
    if VideoProcessor().extract_single_frame(clip, 10_000) is not None:
        raise AssertionError("extract_single_frame past the end")
    pipe = trained_pipeline(state, "crnn")
    reset_counts()
    single = pipe.process_single_frame(one)
    calls, cuda = record_path(results, "hostapi")
    if "error" in single:
        raise AssertionError(f"process_single_frame: {single['error']}")
    texts = sorted(d["text"] for d in single["detections"])
    if texts != sorted(TRUTH) or calls < 1 or neighbor_min_sweeps.launches:
        raise AssertionError(
            f"single frame read {texts}; segmented_cc_round {calls} calls, "
            f"neighbor_min_sweeps {neighbor_min_sweeps.launches}")
    print(f"hostapi extract_single_frame({HOSTAPI_FRAME}) -> "
          f"process_single_frame reads {texts}; segmented_cc_round {calls} "
          f"calls ({cuda} CUDA launches), neighbor_min_sweeps 0")
    one_map_ops(torch, np, results, pipe, frame, card)

    # the schemas rebuild process_video's result dict field for field
    res = asyncio.run(pipe.process_video(clip))
    if res["status"] != "success":
        raise AssertionError(f"process_video: {res}")
    typed = VideoResult(
        status=res["status"],
        results=[FrameResult(f["frame_number"], f["timestamp"],
                             [RecognizedRegion(**d) for d in f["detections"]])
                 for f in res["results"]],
        summary=res["summary"], video_info=res["video_info"])
    if typed.to_dict() != res:
        raise AssertionError("VideoResult.to_dict() differs from the "
                             "pipeline's result")
    n_regions = sum(len(f["detections"]) for f in res["results"])
    print(f"hostapi VideoResult(...).to_dict() equals process_video's "
          f"result: {len(res['results'])} frames, {n_regions} regions")

    # the worker-side metrics server serves the port's registry
    server = metrics.start_metrics_server(0, "127.0.0.1")
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/metrics"
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(url, timeout=30) as resp:
            body = resp.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    frames = metric_value(
        body, 'model_batch_size_sum{model_type="DBNet-CRNN"}')
    if frames <= 0:
        raise AssertionError(f"/metrics counts {frames} CRNN frames")
    print(f"hostapi start_metrics_server: GET /metrics {len(body)} bytes, "
          f"the pipeline's CRNN frames {frames:g}")


ONE_MAP_BOX_TOL = 1e-3  # px, as the CPU parity tests hold boxes
ONE_MAP_SCORE_TOL = 1e-5
ONE_MAP_CROP_TOL = 1e-5


def one_map_ops(torch, np, results, pipe, frame, card):
    """The reference's one-map calls of the per-map ops on the card, on the
    trained detector's maps of B frames (the verify frame, mirrored every
    other frame): ``db_postprocess`` of map 0 against row 0 of the batched
    call, and ``crop_and_resize_boxes_mm`` of image 0 with row 0's boxes
    against row 0 of the batched crop; both kernels counted on the
    one-map call."""
    from vtd_tpu_torch.ops.crop import crop_and_resize_boxes_mm
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess

    frames = np.stack([frame if i % 2 == 0 else frame[:, ::-1]
                       for i in range(B)])
    bgr = torch.from_numpy(np.ascontiguousarray(frames)).cuda()
    kw = dict(max_dets=64, max_box_frac=pipe.max_box_frac)
    with torch.inference_mode():
        prob = pipe.detector.probability(bgr)
        torch.cuda.synchronize()
        reset_counts()
        one = db_postprocess(prob[0], 0.5, **kw)
        torch.cuda.synchronize()
        calls, cuda = record_path(results, "hostapi_one_map")
        batch = db_postprocess(prob, 0.5, **kw)
        crop_one = crop_and_resize_boxes_mm(bgr[0], batch["boxes"][0],
                                            batch["valid"][0])
        crop_batch = crop_and_resize_boxes_mm(bgr, batch["boxes"],
                                              batch["valid"])
        torch.cuda.synchronize()
    if set(one) != set(batch) or one["boxes"].shape != (64, 4):
        raise AssertionError(f"db_postprocess on one map: {sorted(one)}")
    for key in ("valid", "areas"):
        if not torch.equal(one[key], batch[key][0]):
            raise AssertionError(f"db_postprocess on one map: {key} differs")
    box_err = max(float((one[k] - batch[k][0]).abs().max())
                  for k in ("boxes", "polygons", "xmin", "xmax", "ymin",
                            "ymax"))
    score_err = float((one["scores"] - batch["scores"][0]).abs().max())
    crop_err = float((crop_one - crop_batch[0]).abs().max())
    if crop_one.shape != (64, 32, 128, 3):
        raise AssertionError(f"one image's crops {tuple(crop_one.shape)}")
    n_valid = int(one["valid"].sum())
    if not (box_err <= ONE_MAP_BOX_TOL and score_err <= ONE_MAP_SCORE_TOL
            and crop_err <= ONE_MAP_CROP_TOL and n_valid >= len(TRUTH)):
        raise AssertionError(
            f"one map against the batched row: boxes {box_err}, scores "
            f"{score_err}, crops {crop_err}, {n_valid} valid slots")
    if (calls, cuda) != (3, 8):
        raise AssertionError(f"db_postprocess on one map: segmented_cc_round "
                             f"{calls} calls = {cuda} CUDA launches")
    print(f"hostapi one map: db_postprocess([640x640]) equals row 0 of the "
          f"[{B}x640x640] call ({n_valid} valid slots, valid and areas "
          f"equal, boxes within {box_err:.3g} px, scores within "
          f"{score_err:.3g}), segmented_cc_round {calls} calls = {cuda} "
          f"CUDA launches; crop_and_resize_boxes_mm([640x640x3], [64, 4]) "
          f"equals row 0 of the batched crop within {crop_err:.3g} ({card})")


# the default TrOCRConfig split over a row against the unsplit recogniser,
# both bf16 on the card: the encoder output's distance relative to its
# norm (bf16 rounds at 2**-9 relative; the split projections may round
# elsewhere, and 12 layers carry it)
TP_ENC_RTOL = 2e-2
TP_MIN_IOU = 0.95  # a split pipeline's boxes against the fused path's
# a float32 detector's maps split over a row against unsplit, TF32 off:
# the same products in another summation order
TP_MAP_TOL = 1e-4


def tp_phase(torch, np, card, results, state):
    """The mesh's model axis on the card: split pipelines, a split TrOCR,
    a split DBNet step and ``train-detector --mesh 1x2``. Its files live
    in a directory removed after it."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="vtd_tp_") as tmp:
        run_tp(torch, np, card, results, state, tmp)


def box_iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1e-9)


def same_texts_iou(got, want, label: str) -> float:
    """Per frame: the same transcripts, each box at IoU >= TP_MIN_IOU with
    its twin's. Returns the least IoU."""
    worst = 1.0
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} frames, {len(want)}")
    for f, (x, y) in enumerate(zip(got, want)):
        dx = sorted(x, key=lambda d: d["text"])
        dy = sorted(y, key=lambda d: d["text"])
        if [d["text"] for d in dx] != [d["text"] for d in dy]:
            raise AssertionError(f"{label} frame {f}: texts")
        for p, q in zip(dx, dy):
            worst = min(worst, box_iou(p["bbox"], q["bbox"]))
    if worst < TP_MIN_IOU:
        raise AssertionError(f"{label}: a box at IoU {worst:.4f}")
    return worst


def run_tp(torch, np, card, results, state, tmp):
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps
    from vtd_tpu_torch.parallel import n_split
    from vtd_tpu_torch.runtime import TextDetector, VideoTextPipeline
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer
    from vtd_tpu_torch.train.train_detector import main as train_detector_main

    n_cards = torch.cuda.device_count()
    ref = verify_frames(np)
    frames = np.stack([ref["frame_i420"]] * B)
    valid = np.ones(B, bool)
    plan = [(frames, valid, None)] * N_BATCHES

    # -- split CRNN pipelines against the fused path ------------------------
    fused = trained_pipeline(state, "crnn")
    fused.process_batch(frames, valid)  # warm-up
    want, elapsed = run_pipelined(torch, fused, plan)
    rates = {"fused": B * N_BATCHES / elapsed}
    meshes = {"1x2": (1, ["cuda:0"] * 2), "2x2": (2, ["cuda:0"] * 4)}
    if n_cards >= 2:
        meshes["1x2_cards"] = (1, ["cuda:0", "cuda:1"])
    else:
        print("tp: a row over distinct cards: not run (one card visible)")
    for name, (n_rows, devices) in meshes.items():
        pipe = VideoTextPipeline(
            detector_path=CHECKPOINTS["detector"],
            recognizer_path=CHECKPOINTS["crnn"], use_transformer_ocr=False,
            batch_size=B, max_dets=64, host_downscale=640,
            transfer_format="yuv420",
            mesh=make_mesh(n_data=n_rows, n_model=2, devices=devices))
        try:
            split = [(n_split(r.detector.model), n_split(r.recognizer.crnn))
                     for r in pipe.replicas]
            if split != [(38, 13)] * n_rows:
                raise AssertionError(f"tp {name}: split tensors {split}")
            pipe.process_batch(frames, valid)  # warm-up
            reset_counts()
            outs, elapsed = run_pipelined(torch, pipe, plan)
            calls, cuda = record_path(results, f"tp_{name}_path")
            sweeps = neighbor_min_sweeps.launches
        finally:
            pipe.close()
        worst = 1.0
        for k, o in enumerate(outs):
            check_against_reference(o, ref, "crnn")
            worst = min(worst, same_texts_iou(o, want[k],
                                              f"tp {name} batch {k}"))
        if calls != 3 * n_rows * N_BATCHES or sweeps:
            raise AssertionError(
                f"tp {name}: {calls} segmented_cc_round calls and {sweeps} "
                f"neighbor_min_sweeps over {N_BATCHES} batches, expected "
                f"{3 * n_rows * N_BATCHES} and 0")
        rates[name] = B * N_BATCHES / elapsed
        print(f"tp {name} mesh {devices}: DBNet / CRNN split tensors "
              f"{split[0][0]} / {split[0][1]} a row; {N_BATCHES} pipelined "
              f"batches x {B} frames read {sorted(TRUTH)} on every frame, "
              f"texts equal to the fused path, least box IoU {worst:.4f}; "
              f"{calls} segmented_cc_round calls ({cuda} CUDA launches), "
              f"{calls / N_BATCHES / n_rows:g} = "
              f"{cuda / N_BATCHES / n_rows:g} a batch a row; "
              f"neighbor_min_sweeps {sweeps}; {rates[name]:.3f} frames/s "
              f"pipelined against {rates['fused']:.3f} fused ({card})")

    # -- the default TrOCRConfig split over a row ---------------------------
    tr = TransformerRecognizer(seed=0, device="cuda")
    split_tr = tr.replica(["cuda:0", "cuda:0"])
    n_tr = n_split(split_tr.model)
    n_params = sum(p.numel() for p in tr.model.parameters())
    if n_tr != 195:
        raise AssertionError(f"tp TrOCR: {n_tr} split tensors, expected 195")
    c = tr.cfg
    gen = torch.Generator().manual_seed(12)
    crops = (torch.rand((16, c.image_size, c.width, 3), generator=gen) * 2
             - 1).to(c.dtype).cuda()
    ms = {}
    with torch.inference_mode():
        for rec in (tr, split_tr):
            rec.generate(crops[:2])  # warm-up
        for key, rec in (("one", tr), ("split", split_tr)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, conf = rec.generate(crops)
            torch.cuda.synchronize()
            ms[key] = ((time.perf_counter() - t0) * 1e3, toks, conf)
        enc0 = tr.model.encode(crops).float()
        enc1 = split_tr.model.encode(crops).float()
    enc_rel = float((enc1 - enc0).norm() / enc0.norm())
    same_toks = torch.equal(ms["one"][1], ms["split"][1])
    conf_err = float((ms["one"][2] - ms["split"][2]).abs().max())
    print(f"tp TrOCR default config ({n_params / 1e6:.1f} M parameters, "
          f"{c.dtype}), {n_tr} split tensors on [cuda:0, cuda:0]: one chunk "
          f"of 16 crops, tokens equal {same_toks}, confidences within "
          f"{conf_err:.2e}, encoder output {enc_rel:.2e} of its norm off "
          f"(allowed {TP_ENC_RTOL:g}); {ms['split'][0]:.1f} ms a chunk split, "
          f"{ms['one'][0]:.1f} ms unsplit ({card})")
    if not same_toks:
        raise AssertionError("tp TrOCR: split tokens differ from unsplit")
    if not enc_rel <= TP_ENC_RTOL:
        raise AssertionError(f"tp TrOCR: encoder output {enc_rel:.2e} off")
    del tr, split_tr, crops, enc0, enc1, ms
    gc.collect()
    torch.cuda.empty_cache()

    # -- one DBNet step on a 1x2 row ----------------------------------------
    row = ["cuda:0", "cuda:0"]
    tf32_was = torch.backends.cudnn.allow_tf32
    x, t = dp_inputs(torch)
    try:
        one = dp_first_step(torch, x, t, None, tf32=False)[2]
        two = dp_first_step(torch, x, t, None, tf32=False, row=row)[2]
        times = {}
        for key, r in (("one", None), ("split", row)):
            step, model, _ = dp_first_step(torch, x, t, None, tf32=True,
                                           row=r)
            times[key], _ = timed_steps(torch, lambda: step(x, t)["loss"],
                                        DP_STEPS)
            del step, model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_was
    rows = {"1x2": two}
    if n_cards >= 2:
        torch.backends.cudnn.allow_tf32 = False
        try:
            rows["1x2_cards"] = dp_first_step(
                torch, x, t, None, tf32=False, row=["cuda:0", "cuda:1"])[2]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32_was
    for name, got in rows.items():
        dl = abs(got["loss"] - one["loss"]) / abs(one["loss"])
        dn = abs(got["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
        print(f"tp DBNet 640x640 batch {DP_BATCH} float32 from "
              f"{CHECKPOINTS['detector']} on the row {name}: true float32 "
              f"first step against the one-process step: loss rel {dl:.2e} "
              f"(allowed {DP_LOSS_RTOL:g}), gradient norm rel {dn:.2e} "
              f"(allowed {DP_NORM_RTOL:g}) ({card})")
        if not (dl <= DP_LOSS_RTOL and dn <= DP_NORM_RTOL):
            raise AssertionError(f"tp DBNet step {name}: off the one-process "
                                 "step")
    print(f"tp DBNet step on the 1x2 row {row}: "
          f"{float(np.median(times['split'])):.3f} ms/step split, "
          f"{float(np.median(times['one'])):.3f} one process (TF32 "
          f"convolutions, median of {DP_STEPS}, CUDA events; {card})")
    del x, t

    # -- train-detector --mesh 1x2 ------------------------------------------
    res = train_detector_main([
        "--synthetic", "--n-samples", "20", "--image-size", "160",
        "--epochs", "1", "--batch-size", "8", "--mesh", "1x2",
        "--device", "cuda", "--checkpoint-dir", f"{tmp}/dbnet"])
    if res.get("status") != "success":
        raise AssertionError(f"train-detector --mesh 1x2: {res}")
    det = TextDetector(model_path=res["best_model_path"], input_size=160,
                       device="cuda", dtype=torch.float32)
    split_det = det.replica(row)
    frame = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 160, 160, 3), dtype=np.uint8)).cuda()
    # true float32 for this comparison (cuDNN would run TF32)
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            p0, p1 = det.probability(frame), split_det.probability(frame)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_was
    gap = float((p1 - p0).abs().max())
    if not (torch.isfinite(p0).all() and gap <= TP_MAP_TOL):
        raise AssertionError(f"the --mesh 1x2 checkpoint: maps {gap}")
    print(f"train-detector --mesh 1x2 --device cuda: in this process, status "
          f"success, val_loss {res['best_val_loss']:.4f}; its checkpoint "
          f"read by an unsplit TextDetector, whose float32 maps are within "
          f"{gap:.2e} (allowed {TP_MAP_TOL:g}) of the same weights split "
          f"over {row}")
    if n_cards < 4:
        print("tp: train-detector --mesh 2x2 over four cards: not run "
              f"({n_cards} visible)")
        return
    res = train_detector_main([
        "--synthetic", "--n-samples", "20", "--image-size", "160",
        "--epochs", "1", "--batch-size", "8", "--mesh", "2x2",
        "--device", "cuda", "--checkpoint-dir", f"{tmp}/dbnet22"])
    if res.get("status") != "success":
        raise AssertionError(f"train-detector --mesh 2x2: {res}")
    det = TextDetector(model_path=res["best_model_path"], input_size=160,
                       device="cuda")
    with torch.inference_mode():
        if not torch.isfinite(det.probability(frame)).all():
            raise AssertionError("the --mesh 2x2 checkpoint: non-finite maps")
    print(f"train-detector --mesh 2x2 --device cuda: two NCCL ranks on rows "
          f"[cuda:0, cuda:1] and [cuda:2, cuda:3], status success, val_loss "
          f"{res['best_val_loss']:.4f}, checkpoint read by TextDetector")


# the reference's own bound on a native batch against cv2's, mean
# absolute difference of the shipped bytes (tests/test_native_video.py)
DECODE_MEAN_ABS_TOL = 6.0
DECODE_TARGET_FPS = 10.0
DECODE_REPS = 3  # timed runs of each backend, in turns


def libav_versions():
    """``pkg-config --modversion libavcodec libswscale`` on one line, or
    None where that fails (no pkg-config, or no libav .pc files)."""
    try:
        res = subprocess.run(
            ["pkg-config", "--modversion", "libavcodec", "libswscale"],
            capture_output=True, text=True, timeout=60)
    except OSError:
        return None
    return " ".join(res.stdout.split()) if res.returncode == 0 else None


def decode_batches(vp, clip, backend: str, mode: str):
    """All batches of the serve clip as the trained pipeline ships them
    (batch B, 640x640, I420), and the host seconds they took."""
    t0 = time.perf_counter()
    out = list(vp.extract_frame_batches(
        clip, batch_size=B, target_fps=DECODE_TARGET_FPS, resize_to=640,
        pixel_format="yuv420", sample_mode=mode, decode_backend=backend))
    return out, time.perf_counter() - t0


def same_batches(np, got, want, label: str, mean_abs_tol=None) -> float:
    """Batch structure equal (frame numbers, timestamps, valid, orig_size,
    dups); the frames byte-equal, or within ``mean_abs_tol`` mean absolute
    difference a batch. Returns the largest batch's mean difference."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} batches, {len(want)}")
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if g["dups"] != w["dups"] or (g["frames"] is None) != (
                w["frames"] is None):
            raise AssertionError(f"{label} batch {k}: other duplicates")
        if w["frames"] is None:
            continue
        for key in ("frame_numbers", "timestamps", "valid"):
            if not np.array_equal(g[key], w[key]):
                raise AssertionError(f"{label} batch {k}: {key} differ")
        if tuple(g["orig_size"]) != tuple(w["orig_size"]):
            raise AssertionError(f"{label} batch {k}: orig_size "
                                 f"{g['orig_size']} against {w['orig_size']}")
        if g["frames"].shape != w["frames"].shape:
            raise AssertionError(f"{label} batch {k}: frames "
                                 f"{g['frames'].shape}, {w['frames'].shape}")
        diff = float(np.abs(g["frames"].astype(np.int16)
                            - w["frames"].astype(np.int16)).mean())
        worst = max(worst, diff)
        if (not np.array_equal(g["frames"], w["frames"])
                if mean_abs_tol is None else diff >= mean_abs_tol):
            raise AssertionError(f"{label} batch {k}: frames differ by "
                                 f"{diff} mean (allowed {mean_abs_tol})")
    return worst


def timed_process_video(torch, pipe, clip, backend: str):
    """``process_video`` on the trained pipeline at ``backend``; returns
    the result and its host seconds (the card synchronised)."""
    import asyncio

    pipe.decode_backend = backend
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = asyncio.run(pipe.process_video(clip, ""))
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def decode_phase(torch, np, card, results, state):
    """The native libav decoder where the machine has libav, else its
    honest absence. Its files live in a directory removed after it."""
    import tempfile

    pipe = trained_pipeline(state, "crnn")
    backend = pipe.decode_backend
    try:
        with tempfile.TemporaryDirectory(prefix="vtd_decode_") as tmp:
            run_decode(torch, np, card, results, pipe, tmp)
    finally:
        pipe.decode_backend = backend


def run_decode(torch, np, card, results, pipe, tmp):
    import os

    from vtd_tpu_torch.native import video as native_video
    from vtd_tpu_torch.video import VideoProcessor

    missing = native_video.libav_missing()
    versions = libav_versions()
    print(f"decode: libav {'absent' if missing else 'present'} on this "
          f"machine: g++ -E probe of {', '.join(native_video.AV_HEADERS)}: "
          f"{missing or 'all found'}; pkg-config --modversion libavcodec "
          f"libswscale: {versions or 'fails'} ({card})")
    if (missing is None) != (versions is not None):
        raise AssertionError("the decoder's header probe and pkg-config "
                             "disagree on whether libav is here")
    clip = os.path.join(tmp, "clip.mp4")
    n_frames = write_serve_clip(np, clip) // int(
        SERVE_FPS / DECODE_TARGET_FPS)
    vp = VideoProcessor()

    if missing:
        print("decode: the native libav decoder was neither built nor run "
              "on this card: its machine has no libav development files")
        if native_video.available():
            raise AssertionError("available() is True without libav")
        native = vp.extract_frame_batches(clip, decode_backend="native")
        raised = None
        try:
            next(native)
        except ValueError as e:
            raised = str(e)
        if raised != f"native decode unavailable for {clip}":
            raise AssertionError(f"decode_backend='native' without libav "
                                 f"raised {raised!r}")
        auto, _ = decode_batches(vp, clip, "auto", "stride")
        cv, _ = decode_batches(vp, clip, "cv2", "stride")
        same_batches(np, auto, cv, "auto against cv2")
        reset_counts()
        res, wall = timed_process_video(torch, pipe, clip, "auto")
        calls, cuda = record_path(results, "decode_auto")
        n_det = check_served_texts(res, "process_video at auto", n_frames)
        if calls < 1:
            raise AssertionError("process_video at auto launched no "
                                 "segmented_cc_round")
        print(f"decode: available() False; decode_backend='native' raises "
              f"ValueError({raised!r}); 'auto' gave {len(auto)} batches "
              f"byte-equal to 'cv2' on the serve clip; process_video at "
              f"'auto' reads {sorted(TRUTH)} on all {n_frames} frames "
              f"({n_det} detections, {wall * 1e3:.1f} ms), "
              f"segmented_cc_round {calls} calls ({cuda} CUDA launches) "
              f"({card})")
        return

    t0 = time.perf_counter()
    lib = native_video.build()
    print(f"decode: built {os.path.basename(lib)} with g++ in "
          f"{time.perf_counter() - t0:.2f} s")
    for mode in ("stride", "keyframe"):
        nat, _ = decode_batches(vp, clip, "native", mode)
        cv, _ = decode_batches(vp, clip, "cv2", mode)
        worst = same_batches(np, nat, cv, f"native against cv2 ({mode})",
                             DECODE_MEAN_ABS_TOL)
        print(f"decode: {mode}: native and cv2 give the same {len(nat)} "
              f"batches (frame numbers, timestamps, valid, orig_size, "
              f"dups); frames within {worst:.3f} mean absolute difference "
              f"a batch (allowed {DECODE_MEAN_ABS_TOL})")
    host = {"native": [], "cv2": []}
    for _ in range(DECODE_REPS):
        for backend in host:
            got, secs = decode_batches(vp, clip, backend, "stride")
            host[backend].append(secs * 1e3 / len(got))

    timed_process_video(torch, pipe, clip, "cv2")  # warm
    runs = {"native": [], "cv2": []}
    for _ in range(DECODE_REPS):
        for backend in runs:
            reset_counts()
            res, wall = timed_process_video(torch, pipe, clip, backend)
            if backend == "native":
                calls, cuda = record_path(results, "decode_native")
                if calls < 1:
                    raise AssertionError("process_video at native launched "
                                         "no segmented_cc_round")
            check_served_texts(res, f"process_video at {backend}", n_frames)
            runs[backend].append((res, wall))
    if [f["frame_number"] for f in runs["native"][0][0]["results"]] != [
            f["frame_number"] for f in runs["cv2"][0][0]["results"]]:
        raise AssertionError("native and cv2 process_video: other frames")

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    fps = {k: med([n_frames / w for _, w in v]) for k, v in runs.items()}
    print(f"decode: process_video on the serve clip ({n_frames} frames, "
          f"trained CRNN pipeline, batch {B}, I420 640x640), median of "
          f"{DECODE_REPS}: native {fps['native']:.1f} frames/s, cv2 "
          f"{fps['cv2']:.1f} frames/s; host ms a decoded batch of {B}: "
          f"native {med(host['native']):.2f}, cv2 {med(host['cv2']):.2f}; "
          f"segmented_cc_round {calls} calls ({cuda} CUDA launches) on the "
          f"native path ({card})")


BENCH_METRICS = {
    "3": "e2e_720p_ocr_frames_per_sec_per_chip",
    "3dr": "e2e_720p_ocr_fps_device_resident",
    "5": "multistream_aggregate_fps",
    "4": "e2e_1080p_keyframe_ocr_fps",
    "1": "dbnet_single_frame_detect_fps",
    "2": "crnn_ctc_crops_per_sec",
}
BENCH_TIMEOUT_S = 700.0
PROFILE_ITERS = 10
TROCR_HELDOUT_CKPT = "demo_models2/trocr_r5/trocr_final"


def bench_phase(card, results):
    """The port's bench in a subprocess, as a user runs it; every line
    checked, the kernels' counts of each config into the kernels line."""
    print("bench: python -m vtd_tpu_torch.bench --all", flush=True)
    res = subprocess.run(
        [sys.executable, "-m", "vtd_tpu_torch.bench", "--all"],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    lines = {}
    for ln in res.stdout.splitlines():
        print(ln)
        if ln.startswith("{"):
            rec = json.loads(ln)
            lines[rec["metric"]] = rec
    if res.returncode != 0:
        raise AssertionError(f"bench exited {res.returncode}:\n"
                             f"{res.stderr[-3000:]}")
    name, limit = (part.strip() for part in card.split(",", 1))
    for spec, metric in BENCH_METRICS.items():
        rec = lines.get(metric)
        if rec is None or "error" in rec or not rec["value"] > 0:
            raise AssertionError(f"bench config {spec}: {rec}")
        if (rec["card_name"], rec["power_limit"]) != (name, limit):
            raise AssertionError(f"bench config {spec} names another card: "
                                 f"{rec['card_name']}, {rec['power_limit']}")
        calls = rec["segmented_cc_round_calls"]
        if spec != "2" and calls < 1:
            raise AssertionError(f"bench config {spec} launched no "
                                 "segmented_cc_round")
        record_launches(results, "segmented_cc_round",
                        f"launches_bench_{spec}", calls)
        record_launches(results, "segmented_cc_round",
                        f"cuda_launches_bench_{spec}",
                        rec["segmented_cc_round_cuda_launches"])
        record_launches(results, "neighbor_min_sweeps",
                        f"launches_bench_{spec}",
                        rec["neighbor_min_sweeps_calls"])
    print(f"bench: {len(BENCH_METRICS)} lines under their metric names, each with a "
          f"value above 0, no error and {card}")


def profile_phase(card, results):
    """``profile_device`` at batch 16 on the trained checkpoints."""
    from vtd_tpu_torch.tools.profile_device import (
        STAGES, profile_stages, report,
    )

    reset_counts()
    res = profile_stages(batch=B, iters=PROFILE_ITERS)
    record_path(results, "profile")
    print(report(res, B, PROFILE_ITERS, card))
    if list(res["stages"]) != list(STAGES):
        raise AssertionError(f"profile stages {list(res['stages'])}")
    for name, st in res["stages"].items():
        if not (st["device_ms"] and st["device_ms"] > 0 and st["wall_ms"] > 0):
            raise AssertionError(f"profile stage {name}: {st}")
    if res["counts"]["segmented_cc_round_calls"] < 1:
        raise AssertionError("profile launched no segmented_cc_round")


class _Tee(io.StringIO):
    """Keeps what is printed and passes it on to the real stdout."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def run_printing(fn, *args):
    """``fn(*args)`` with its stdout shown and kept -> (result, text)."""
    out = _Tee()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    sys.__stdout__.flush()
    return result, out.getvalue()


def examples_phase(card, results):
    """The port's examples and the TrOCR scorer, each in this process with
    the kernels counted around it."""
    import tempfile

    from vtd_tpu_torch.examples import train_and_verify, verify_checkpoints
    from vtd_tpu_torch.tools import eval_trocr_ckpt

    reset_counts()
    t0 = time.perf_counter()
    rc, text = run_printing(verify_checkpoints.main, [])
    calls, cuda = record_path(results, "verify_checkpoints")
    if rc != 0 or "VERIFY PASS" not in text or text.count('"clean": true') != 2:
        raise AssertionError("verify_checkpoints did not pass on both engines")
    print(f"verify_checkpoints: VERIFY PASS on the CRNN and the TrOCR path in "
          f"{time.perf_counter() - t0:.1f} s; segmented_cc_round {calls} "
          f"calls ({cuda} CUDA launches) ({card})")

    with tempfile.TemporaryDirectory(prefix="vtd_tav_") as out:
        reset_counts()
        t0 = time.perf_counter()
        rc, text = run_printing(train_and_verify.main,
                                ["--quick", "--out", out])
        calls, cuda = record_path(results, "train_and_verify")
        if rc != 0 or "REPORT WRITTEN" not in text:
            raise AssertionError("train_and_verify --quick did not finish")
    print(f"train_and_verify --quick: {time.perf_counter() - t0:.1f} s; "
          f"segmented_cc_round {calls} calls ({cuda} CUDA launches) ({card})")

    reset_counts()
    t0 = time.perf_counter()
    score = eval_trocr_ckpt.evaluate(TROCR_HELDOUT_CKPT)
    record_path(results, "eval_trocr_ckpt")
    print(json.dumps(score))
    if score["heldout_exact_match_random8"] != "32/32":
        raise AssertionError(f"eval_trocr_ckpt read {score}")
    print(f"eval_trocr_ckpt: 32/32 in {time.perf_counter() - t0:.1f} s "
          f"({card})")


REPORT = "demo_models2/report.json"
R5_DIR = "demo_models2/trocr_r5"
REPORT_CONF_TOL = 0.001  # avg_det_conf is kept to 3 decimals


def same_section(got: dict, want: dict, label: str) -> None:
    """A report section key for key, ``avg_det_conf`` within
    REPORT_CONF_TOL."""
    if set(got) != set(want):
        raise AssertionError(f"{label} keys {sorted(got)} != {sorted(want)}")
    for key, value in want.items():
        ok = (abs(got[key] - value) <= REPORT_CONF_TOL
              if key == "avg_det_conf" else got[key] == value)
        if not ok:
            raise AssertionError(f"{label}.{key}: {got[key]!r} != {value!r}")


def report_phase(card, results):
    """``update_report`` and ``r5_promote`` on the card, each in this
    process with the kernels counted around it."""
    import math
    import os
    import tempfile

    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer
    from vtd_tpu_torch.tools import r5_promote, update_report
    from vtd_tpu_torch.tools.eval_trocr_ckpt import evaluate

    with open(REPORT) as f:
        want = json.load(f)
    with tempfile.TemporaryDirectory(prefix="vtd_report_") as tmp:
        out = os.path.join(tmp, "report.json")
        reset_counts()
        t0 = time.perf_counter()
        rc, text = run_printing(update_report.main, ["--out", out])
        calls, cuda = record_path(results, "update_report")
        secs = time.perf_counter() - t0
        if rc != 0 or "REPORT UPDATED" not in text:
            raise AssertionError("update_report did not finish")
        if text.splitlines()[0] != f"device: {card}":
            raise AssertionError(f"update_report names {text.splitlines()[0]}")
        with open(out) as f:
            got = json.load(f)
        if set(got) != set(want):
            raise AssertionError(f"update_report sections {sorted(got)}")
        for name in want:
            if name in ("e2e", "e2e_transformer"):
                same_section(got[name], want[name], name)
            elif got[name] != want[name]:
                raise AssertionError(f"update_report changed {name}")
        batches = sum(math.ceil(got[name]["frames"] / 8)
                      for name in ("e2e", "e2e_transformer"))
        if calls < batches:
            raise AssertionError(f"update_report: {calls} segmented_cc_round "
                                 f"calls over {batches} batches")
        print(f"update_report: e2e and e2e_transformer as {REPORT} (avg_det_conf "
              f"{got['e2e']['avg_det_conf']} within {REPORT_CONF_TOL}), trocr "
              f"untouched, in {secs:.1f} s; segmented_cc_round {calls} calls "
              f"({cuda} CUDA launches) over {batches} batches, "
              f"{calls / batches:g} = {cuda / batches:g} a batch ({card})")

        reset_counts()
        t0 = time.perf_counter()
        rc, text = run_printing(r5_promote.main, [R5_DIR])
        if rc != 0 or f"{R5_DIR}/trocr_final: 32/32" not in text:
            raise AssertionError(f"r5_promote gave {rc}")
        dest = os.path.join(tmp, "promoted", "text_recognizer_trocr")
        rc, text = run_printing(r5_promote.main,
                                [R5_DIR, "--promote", "--dest", dest])
        if rc != 0 or not os.path.isdir(dest):
            raise AssertionError(f"r5_promote --promote gave {rc}")
        TransformerRecognizer(model_path=dest)
        score = evaluate(dest, dest + "_config.json")
        if score["heldout_exact_match_random8"] != "32/32":
            raise AssertionError(f"the promoted copy read {score}")
        kept = os.path.join(tmp, "kept", "text_recognizer_trocr")
        rc, text = run_printing(
            r5_promote.main,
            [R5_DIR, "--promote", "--incumbent-score", "32", "--dest", kept])
        if rc != 3 or os.path.exists(kept):
            raise AssertionError(f"r5_promote --incumbent-score 32 gave {rc}")
        calls, cuda = record_path(results, "r5_promote")
    print(f"r5_promote: trocr_final 32/32, promoted copy loads and reads "
          f"32/32, --incumbent-score 32 exits 3, in "
          f"{time.perf_counter() - t0:.1f} s; segmented_cc_round {calls} "
          f"calls ({cuda} CUDA launches) ({card})")


PHASES = ("segmented", "sweeps", "dense", "crnn", "trocr", "trained",
          "engine", "beam", "serve", "fleet", "train", "parallel",
          "hostapi", "tp", "decode", "bench", "profile", "examples",
          "report")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated subset of %(default)s, for a short run while "
             "working on one phase; the default runs them all",
    )
    parser.add_argument(
        "--baseline", metavar="DIR",
        help="another checkout (e.g. the parent commit unpacked with git "
             "archive) whose neighbor_min_sweeps is timed beside this one's "
             "in the sweeps and dense phases, and both wrappers' host time "
             "per batched call in the single-map checks",
    )
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np

    from vtd_tpu_torch._build import build_all

    card = card_line()
    t_script = t0 = time.perf_counter()
    logs = build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu\n{log.strip()}")
    print(card)

    if args.baseline:
        load_baseline(args.baseline)
    results: dict = {}
    state: dict = {}  # pipelines shared by the trained-weights phases
    run = {
        "segmented": lambda: segmented_phase(torch, np, results, card,
                                             args.baseline),
        "sweeps": lambda: sweeps_phase(torch, np, results, card,
                                       args.baseline),
        "dense": lambda: dense_phase(torch, np, results, args.baseline),
        "crnn": lambda: pipeline_phase(torch, np, card, results),
        "trocr": lambda: trocr_phase(torch, np, card, results),
        "trained": lambda: trained_phase(torch, np, card, results, state),
        "engine": lambda: engine_phase(torch, np, card, results, state),
        "beam": lambda: beam_phase(torch, np, card, state),
        "serve": lambda: serve_phase(torch, np, card, results, state),
        "fleet": lambda: fleet_phase(torch, np, card, results, state),
        "train": lambda: train_phase(torch, np, card),
        "parallel": lambda: parallel_phase(torch, np, card, results, state),
        "hostapi": lambda: hostapi_phase(torch, np, card, results, state),
        "tp": lambda: tp_phase(torch, np, card, results, state),
        "decode": lambda: decode_phase(torch, np, card, results, state),
        "bench": lambda: bench_phase(card, results),
        "profile": lambda: profile_phase(card, results),
        "examples": lambda: examples_phase(card, results),
        "report": lambda: report_phase(card, results),
    }
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            run[name]()
            # free what the phase held (CUDA graphs and their pools, test
            # maps) before the next phase's timings
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    print(f"script: {time.perf_counter() - t_script:.1f} s")

    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
