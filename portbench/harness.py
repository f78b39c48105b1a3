"""One run of one cell: set-up, the measured window, the per-layer reading
and the check against the plain reference.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration's file (``configs/<name>.json``), the traffic mix's
data file (``traffic/<name>.json``), the loop it names
(``loops/<loop>.py``) and each per-layer metric's reader
(``metrics/<name>.py``). ``calibrate.py`` runs this same path with
``calibrate=True`` to read the limits' lower and upper readings.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "vtd_tpu")


class Spec:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> Dict:
        for c in self.bench["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        with open(os.path.join(self.root, "portbench", "traffic", name + ".json")) as f:
            return json.load(f)

    def metrics_for(self, cell: Dict, trace: bool) -> List[Dict]:
        """The metrics the cell reports in a run of this kind."""
        keep = []
        for m in self.bench["per_layer" if trace else "end_to_end"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            keep.append(m)
        return keep


def reader(name: str):
    return importlib.import_module(f"portbench.metrics.{name}")


def driver(traffic: Dict, pipe, inputs: Dict, seed: int, log):
    """The mix's loop (``loops/<loop>.py``) over the built pipeline."""
    mod = importlib.import_module(f"portbench.loops.{traffic['loop']}")
    return mod.Driver(traffic, pipe, inputs, seed, log)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> Dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
        name, limit = (p.strip() for p in line.split(",", 1))
        return {"name": name, "power_limit": limit}
    except Exception as e:  # the result line still names the device
        return {"name": None, "power_limit": None, "error": str(e)[:200]}


def build_pipeline(cfg: Dict, traffic: Dict, device: str, root: str,
                   trocr_weights=None):
    """The port's ``VideoTextPipeline`` as the configuration and the mix
    state it."""
    from vtd_tpu_torch.runtime import VideoTextPipeline

    kw = dict(cfg["pipeline"])
    kw.update(traffic.get("pipeline", {}))
    det_w = cfg["detector"]["weights"]
    kw["detector_path"] = os.path.join(root, det_w)
    rec = cfg["recognizer"]
    if rec["engine"] == "crnn":
        kw["recognizer_path"] = os.path.join(root, rec["weights"])
    else:
        kw["recognizer_kwargs"] = {"transformer_config": trocr_config(rec["trocr"])}
    pipe = VideoTextPipeline(device=device, **kw)
    if trocr_weights is not None:
        pipe.recognizer.transformer.model.load_state_dict(trocr_weights)
    return pipe


def trocr_config(tc: Dict):
    import torch

    from vtd_tpu_torch.models.trocr import TrOCRConfig

    fields = {k: v for k, v in tc.items() if k in TrOCRConfig.__dataclass_fields__}
    fields["dtype"] = getattr(torch, tc["dtype"])
    return TrOCRConfig(**fields)


def metric_context(taps, sub_red, sub, sub_counters, cfg, engine_batches):
    return {
        "spans": dict(taps.host), "calls": dict(taps.calls),
        "counts": dict(taps.counts), "sub": sub_red,
        "sub_t0": sub.t0 if sub else None, "sub_t1": sub.t1 if sub else None,
        "sub_counters": sub_counters, "config": cfg,
        "engine_batches": engine_batches,
    }


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        root: str = ROOT, device: str = "cuda", t_start: Optional[float] = None,
        log=sys.stderr, calibrate: bool = False) -> Dict:
    """One run -> the result dict (``correct`` ... ``checks``). With
    ``calibrate`` the result also holds ``calibration``: the control's
    and the planted faults' readings on the window's own samples."""
    import torch

    from . import clips as clipgen
    from . import profiling
    from .reference.judge import Reference, judge, no_tf32, verdict
    from .reference.weights import read_variables
    from .taps import Taps
    from .weights import trocr_weights

    t_start = time.perf_counter() if t_start is None else t_start

    def mark(what):
        print(f"setup {what} {time.perf_counter() - t_start:.3f}", file=log)

    spec = Spec(root)
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    torch.manual_seed(seed % (1 << 63))

    inputs = clipgen.make(cell["traffic"], traffic["clip"], traffic["clips"], seed,
                          traffic.get("warm_seconds", 2),
                          root=os.path.join(root, ".portbench_cache", "clips"))
    mark("clips")
    tw = None
    if cfg["recognizer"]["engine"] == "trocr":
        tw = trocr_weights(cfg["recognizer"]["trocr"], seed, device)
    pipe = build_pipeline(cfg, traffic, device, root, tw)
    del tw
    mark("pipeline")
    taps = Taps(pipe, seed, traffic.get("sample_batches", 3), trace).install()
    loop = driver(traffic, pipe, inputs, seed, log)
    loop.warm()
    sub = profiling.SubWindow() if trace and device == "cuda" else None
    if sub is not None:
        sub.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    mark("warm")
    setup_s = time.perf_counter() - t_start

    sub_counters = {}

    def on_sub(start: bool):
        from vtd_tpu_torch.ops.cc_kernels import segmented_cc_round

        if start:
            sub_counters["_l0"] = segmented_cc_round.launches
            sub.start()
        else:
            sub.stop()
            sub_counters["segmented_cc_round.launches"] = (
                segmented_cc_round.launches - sub_counters.pop("_l0"))

    # the sub-window: the mix's where its batches are sparse, else the config's
    prof = traffic.get("profile") or cfg.get("profile", {"start_s": 2.0, "seconds": 1.0})
    window = loop.window(seconds, taps, on_sub if sub else None,
                         prof["start_s"], prof["seconds"])
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    e2e = {"setup_s": setup_s, **window["metrics"]}
    red = profiling.reduce(sub) if sub else None
    if red is not None:
        print(f"sub-window {red['window_s']:.3f} s, busy {red['busy_s']:.3f} s, "
              f"counters {sub_counters}, ranges {red['range_count']}", file=log)
    ctx = metric_context(taps, red, sub, sub_counters, cfg,
                         window.get("engine_batches"))
    metrics = {}
    for m in spec.metrics_for(cell, trace):
        value = reader(m["name"]).read(ctx) if trace else e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    size = int(cfg["pipeline"].get("detector_input_size", 640))
    target_fps = float(traffic.get("pipeline", {}).get(
        "target_fps", cfg["pipeline"].get("target_fps", 10.0)))
    samples = taps.finished_samples(size, target_fps)
    taps.uninstall()
    loop.close()
    pipe.close()
    del pipe, loop
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the reference, after the window and the peak
    rec_w = (read_variables(os.path.join(root, cfg["recognizer"]["weights"]))
             if cfg["recognizer"]["engine"] == "crnn"
             else trocr_weights(cfg["recognizer"]["trocr"], seed, device))
    ref = Reference(cfg, read_variables(os.path.join(root, cfg["detector"]["weights"])),
                    rec_w, device)
    with no_tf32(), torch.no_grad():
        readings = judge(samples, ref)
        held = verdict(readings, cfg["limits"])
        cal = calibration(samples, ref, readings, cfg, seed) if calibrate else None
    checks = {k: {"value": c["value"], "limit": c["limit"]} for k, c in held.items()}
    correct = bool(all(c["ok"] for c in held.values())
                   and samples and window["failed"] == 0 and window["attempted"] > 0)
    window["samples_judged"] = len(samples)

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace and red is not None:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
        result["breakdown"] = profiling.breakdown(red)
    result["card"] = card() if device == "cuda" else {}
    if cal is not None:
        result["calibration"] = cal
    result["run"] = {k: v for k, v in window.items() if k not in ("metrics",)}
    result["checks"] = checks
    return result


def calibration(samples, ref, readings: Dict, cfg: Dict, seed: int) -> Dict:
    """The control, one layer at a time in the program's place, and each
    planted fault, judged by ``verdict`` as the run is: each with the
    numbers it moves and the limits it fails."""
    from .reference import control, faults
    from .reference.judge import judge, verdict

    limits = cfg["limits"]

    def fails(r):
        return sorted(k for k, c in verdict(r, limits).items() if not c["ok"])

    out = {"program": readings, "control": {}, "faults": {}}
    for layer, moved in control.readings(samples, ref).items():
        out["control"][layer] = {"readings": moved,
                                 "fails": fails(dict(readings, **moved))}
    for name, number in faults.READS.items():
        r = judge(faults.plant(name, samples, seed, ref.engine, ref.max_dets), ref)
        out["faults"][name] = {"readings": {number: r[number]}, "fails": fails(r)}
    return out
