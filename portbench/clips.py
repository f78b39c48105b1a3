"""Synthetic clips drawn from the seed, encoded as mp4v and cached.

Two kinds, after the repo's bench configs 3 and 4, with their strings
and places (the mix's file lists the strings), so that every seed gives
the detector the same text and the recognizer the same crops; the seed
moves what does not change the work:

``text720``  1280x720: a smooth gradient, the mix's four strings, and a
             disc below them whose motion starts at a phase drawn from the
             seed.
``static1080`` 1920x1080: a gradient whose phases come from the seed, and
             one persistent string.

A mix's clips are cached under ``<checkout>/.portbench_cache/clips/
<mix>-<seed>/``; the clips of other seeds of the same mix are removed
first, so a checkout holds one seed's clips a mix.
"""
from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

DISC_Y, DISC_R = 652, 60
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".portbench_cache", "clips")


def text720_frames(rng: np.random.Generator, seconds: float, fps: int,
                   texts: List[str]):
    import cv2

    w, h = 1280, 720
    yy, xx = np.mgrid[0:h, 0:w]
    base = (80 + 60 * np.sin(xx / 200.0) + 50 * np.cos(yy / 150.0)).astype(np.uint8)
    frame0 = np.clip(np.stack([base, base + 20, base + 40], -1), 0, 255).astype(np.uint8)
    for k, t in enumerate(texts):
        cv2.putText(frame0, t, (80 + 40 * k, 150 + 140 * k),
                    cv2.FONT_HERSHEY_SIMPLEX, 2.2, (0, 0, 0), 5)
    # the disc moves in the band of rows [top, bot), below the text
    top, bot = DISC_Y - DISC_R - 2, DISC_Y + DISC_R + 2
    band0 = frame0[top:bot].copy()
    phase = float(rng.uniform(0, 2 * np.pi))
    frame = frame0.copy()
    for i in range(int(seconds * fps)):
        frame[top:bot] = band0
        cx = 640 + int(150 * np.sin(i / 15.0 + phase))
        cv2.circle(frame, (cx, DISC_Y), DISC_R, (60, 90, 160), -1)
        yield frame


def static1080_frames(rng: np.random.Generator, seconds: float, fps: int,
                      text: str):
    import cv2

    w, h = 1920, 1080
    yy, xx = np.mgrid[0:h, 0:w]
    dx, dy = rng.uniform(0, 2 * np.pi, 2)
    base = (90 + 50 * np.sin(xx / 300.0 + dx)
            + 40 * np.cos(yy / 200.0 + dy)).astype(np.uint8)
    frame = np.stack([base, base + 15, base + 30], -1).astype(np.uint8)
    cv2.putText(frame, text, (300, 540), cv2.FONT_HERSHEY_SIMPLEX, 3.0,
                (0, 0, 0), 8)
    for _ in range(int(seconds * fps)):
        yield frame


def write_clip(path: str, frames, fps: int) -> None:
    import cv2

    writer = None
    try:
        for frame in frames:
            if writer is None:
                h, w = frame.shape[:2]
                writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                         float(fps), (w, h))
            writer.write(frame)
    finally:
        if writer is not None:
            writer.release()


def _frames(spec: Dict, rng: np.random.Generator, seconds: float):
    kind = spec["kind"]
    if kind == "text720":
        return text720_frames(rng, seconds, spec["fps"], spec["texts"])
    if kind == "static1080":
        return static1080_frames(rng, seconds, spec["fps"], spec["text"])
    raise ValueError(f"unknown clip kind {kind!r}")


def make(mix: str, spec: Dict, count: int, seed: int, warm_seconds: float,
         root: str = CACHE) -> Dict[str, List[str]]:
    """{'clips': the mix's ``count`` clips, 'warm': one short clip of the
    same kind} for ``seed``, made on first use and cached."""
    here = os.path.join(root, f"{mix}-{seed}")
    if os.path.isdir(root):
        for name in os.listdir(root):
            if name.startswith(mix + "-") and name != f"{mix}-{seed}":
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    paths = [os.path.join(here, f"clip{i}.mp4") for i in range(count)]
    warm = os.path.join(here, "warm.mp4")
    done = os.path.join(here, "done")
    if not os.path.exists(done):
        os.makedirs(here, exist_ok=True)
        jobs = [(p, np.random.default_rng([seed, i]), spec["seconds"])
                for i, p in enumerate(paths)]
        jobs.append((warm, np.random.default_rng([seed, 1 << 20]), warm_seconds))
        with ThreadPoolExecutor(max_workers=min(len(jobs), 4)) as pool:
            list(pool.map(lambda j: write_clip(j[0], _frames(spec, j[1], j[2]),
                                               spec["fps"]), jobs))
        open(done, "w").close()
    return {"clips": paths, "warm": [warm]}
