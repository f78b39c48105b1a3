"""Open loop: clips arrive on a schedule, whether or not the pipeline
keeps up.

``ceil(rate * seconds)`` gaps, the quantiles ``-ln(1 - (i + 0.5) / n) /
rate`` of an exponential law (so every seed sends the same gaps, in an
order of its own). Each clip is decoded by a thread of its own and
submitted batch by batch with ``InferenceEngine.submit_batch``, as
``process_videos``'s worker does. A clip's latency runs from when it was
due to when its last batch's result resolves; a clip that fails or never
resolves counts as missing (infinite). ``clip_latency_p50_ms`` and
``_p95_ms`` are nearest-rank percentiles over every clip due in the
window. No cell of ``BENCHMARK.json`` runs it yet (``sweep.py`` fixes a
mix's rate).
"""
from __future__ import annotations

import math
import random
import threading
import time
from typing import Dict, List

import numpy as np

from ._common import profile_sub_window

MISSING_MS = 1e9


class Driver:
    def __init__(self, traffic, pipe, inputs, seed, log):
        from vtd_tpu_torch.runtime.engine import InferenceEngine

        self.t = traffic
        self.pipe = pipe
        self.clips = inputs["clips"]
        self.warm_clip = inputs["warm"][0]
        self.rng = random.Random(seed)
        self.log = log
        self.engine = InferenceEngine(pipeline=pipe)

    def _clip(self, path) -> None:
        """``process_videos``'s worker for one clip: decode, submit each
        batch, wait for every batch's result."""
        pipe = self.pipe
        vp = pipe.video_processor
        info = vp.get_video_info(path)
        if not info:
            raise ValueError(f"Cannot open video: {path}")
        pending = []
        for batch in vp.extract_frame_batches(
                path, batch_size=pipe.batch_size, target_fps=pipe.target_fps,
                resize_to=pipe.ship_dims(info), pixel_format=pipe.transfer_format,
                decode_backend=pipe.decode_backend):
            if batch.get("frames") is None:
                continue
            pending.append(self.engine.submit_batch(
                batch["frames"], batch["valid"], orig_size=batch["orig_size"]))
        for fut in pending:
            fut.result(timeout=600)

    def warm(self):
        self._clip(self.warm_clip)

    def window(self, seconds, taps, on_sub, prof_start, prof_seconds) -> Dict:
        rate = float(self.t["rate_per_s"])
        n = max(1, math.ceil(rate * seconds))
        gaps = [-math.log(1 - (i + 0.5) / n) / rate for i in range(n)]
        self.rng.shuffle(gaps)
        order = [self.rng.randrange(len(self.clips)) for _ in range(n)]
        recs: List[Dict] = []
        threads = []
        b0 = self.engine.batches_dispatched
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def one(rec):
            try:
                self._clip(rec["path"])
                rec["done"] = time.perf_counter()
            except Exception as e:  # counted as missing
                rec["error"] = str(e)[:200]

        def arrivals():
            due = t0
            for gap, k in zip(gaps, order):
                due += gap
                if due >= t_end:
                    break
                time.sleep(max(0.0, due - time.perf_counter()))
                rec = {"due": due, "start": time.perf_counter(), "path": self.clips[k]}
                recs.append(rec)
                th = threading.Thread(target=one, args=(rec,), daemon=True)
                th.start()
                threads.append(th)
            time.sleep(max(0.0, t_end - time.perf_counter()))

        taps.open = True
        sched = threading.Thread(target=arrivals, daemon=True)
        sched.start()
        profile_sub_window(on_sub, t0, prof_start, prof_seconds, sched)
        sched.join()
        deadline = t_end + float(self.t.get("wait_s", 60))
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))
        taps.open = False
        lat = sorted((r["done"] - r["due"]) * 1e3 if "done" in r else MISSING_MS
                     for r in recs)
        late = [r["start"] - r["due"] for r in recs]

        def rank(p):
            return lat[max(0, math.ceil(p * len(lat)) - 1)] if lat else MISSING_MS

        failed = sum(1 for r in recs if "done" not in r)
        return {"metrics": {"clip_latency_p50_ms": rank(0.50),
                            "clip_latency_p95_ms": rank(0.95)},
                "attempted": len(recs), "failed": failed,
                "engine_batches": self.engine.batches_dispatched - b0,
                "generator_late_ms_max": max(late) * 1e3 if late else 0.0,
                "generator_late_ms_mean": float(np.mean(late)) * 1e3 if late else 0.0,
                "window_s": seconds}

    def close(self):
        self.engine.close()
