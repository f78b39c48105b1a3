"""Where replicas of the trained CRNN pipeline spend their time on one
card: the fused pipeline, a mesh of one replica and a mesh of two on
``cuda:0``, each over 6 pipelined batches of 16 copies of the shipped
frame (config 3's settings).

Prints, for each, frames/s, every block's dispatch (thread, start ms,
duration ms), and under ``torch.profiler`` (every thread) over 3 more
batches the device's kernel time against the wall time and the CPU ops
that took the most time (``cudaLaunchKernel`` among them).

Run on the card from the repo's root:  python3 tools/torch_replica_probe.py
"""
from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from vtd_tpu_torch.core.mesh import make_mesh  # noqa: E402
from vtd_tpu_torch.runtime import VideoTextPipeline  # noqa: E402


def build(devices):
    return VideoTextPipeline(
        detector_path=cs.CHECKPOINTS["detector"],
        recognizer_path=cs.CHECKPOINTS["crnn"], use_transformer_ocr=False,
        batch_size=cs.B, max_dets=64, host_downscale=640,
        transfer_format="yuv420",
        mesh=None if devices is None else make_mesh(
            n_data=len(devices), devices=devices))


def main() -> None:
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    ref = cs.verify_frames(np)
    frames = np.stack([ref["frame_i420"]] * cs.B)
    valid = np.ones(cs.B, bool)
    print(cs.card_line())
    for devices in (None, ["cuda:0"], ["cuda:0", "cuda:0"]):
        pipe = build(devices)
        try:
            pipe.process_batch(frames, valid)
            calls = []
            run = pipe._dispatch_on

            def timed(*args, _run=run):
                t0 = time.perf_counter()
                out = _run(*args)
                calls.append((threading.current_thread().name, t0,
                              time.perf_counter()))
                return out

            pipe._dispatch_on = timed
            _, elapsed = cs.run_pipelined(torch, pipe,
                                          [(frames, valid, None)] * 6)
            base = calls[0][1]
            print(f"{devices or 'fused'}: {6 * cs.B / elapsed:.1f} frames/s; "
                  "blocks (thread, start ms, ms): "
                  + ", ".join(f"({n[-4:]}, {(a - base) * 1e3:.1f}, "
                              f"{(b - a) * 1e3:.1f})" for n, a, b in calls))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         experimental_config=_ExperimentalConfig(
                             profile_all_threads=True)) as prof:
                t0 = time.perf_counter()
                cs.run_pipelined(torch, pipe, [(frames, valid, None)] * 3)
                wall = time.perf_counter() - t0
            events = prof.key_averages()
            kern = sum(e.self_device_time_total for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]
            print(f"  device kernel time {kern / 1e3:.1f} ms of "
                  f"{wall * 1e3:.1f} ms wall (3 batches, profiler on); CPU "
                  "top: " + ", ".join(f"{e.key[:32]} "
                                      f"{e.self_cpu_time_total / 1e3:.1f} ms"
                                      for e in top))
        finally:
            pipe.close()


if __name__ == "__main__":
    main()
