"""Closed loop: one client sends ``process_video`` jobs back to back,
cycling over the mix's clips in an order drawn from the seed.

Each batch that ``process_video``'s own ``progress_callback`` reports
inside the window counts its frames (keyframe duplicates included); once
the window has closed the callback raises ``InterruptedError``, the
pipeline's cooperative cancellation. ``frames_per_s`` is the frames
completed in the window over its length. The mix's ``pipeline`` holds
constructor overrides and its ``process_video`` the job's keywords
(``sample_mode``, ``temporal_dedup``).
"""
from __future__ import annotations

import asyncio
import random
import threading
import time
from typing import Dict, List

from ._common import profile_sub_window


class Driver:
    def __init__(self, traffic, pipe, inputs, seed, log):
        self.t = traffic
        self.pipe = pipe
        self.clips = inputs["clips"]
        self.warm_clip = inputs["warm"][0]
        self.rng = random.Random(seed)
        self.log = log
        self.kw = dict(traffic.get("process_video", {}))

    def _job(self, path, cb=None):
        return asyncio.run(self.pipe.process_video(path, "", progress_callback=cb,
                                                   **self.kw))

    def warm(self):
        res = self._job(self.warm_clip)
        if res.get("status") != "success":
            raise RuntimeError(f"warm-up job failed: {res.get('error')}")

    def window(self, seconds, taps, on_sub, prof_start, prof_seconds) -> Dict:
        order = list(range(len(self.clips)))
        self.rng.shuffle(order)
        done: List[tuple] = []  # (time, frames) per reported batch
        state = {"attempted": 0, "failed": 0, "jobs_done": 0}
        t0 = time.perf_counter()
        t_end = t0 + seconds

        async def cb(progress, frame_count, total):
            now = time.perf_counter()
            delta = frame_count - cb.last
            cb.last = frame_count
            if now <= t_end:
                done.append((now, delta))
            else:
                raise InterruptedError("window closed")

        def client():
            i = 0
            while time.perf_counter() < t_end:
                path = self.clips[order[i % len(order)]]
                i += 1
                cb.last = 0
                state["attempted"] += 1
                try:
                    res = self._job(path, cb)
                except InterruptedError:
                    break
                if res.get("status") != "success":
                    state["failed"] += 1
                    print(f"job failed: {res.get('error')}", file=self.log)
                else:
                    state["jobs_done"] += 1

        taps.open = True
        th = threading.Thread(target=client, daemon=True)
        th.start()
        profile_sub_window(on_sub, t0, prof_start, prof_seconds, th)
        th.join(timeout=seconds + 600)
        taps.open = False
        frames = sum(n for _, n in done)
        return {"metrics": {"frames_per_s": frames / seconds},
                "attempted": state["attempted"], "failed": state["failed"],
                "frames": frames, "jobs_done": state["jobs_done"],
                "window_s": seconds}

    def close(self):
        pass
