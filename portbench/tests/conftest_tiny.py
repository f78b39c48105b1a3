"""A tiny copy of the benchmark for the CPU tests.

``make_root(dst)`` copies ``portbench/`` and ``BENCHMARK.json`` into
``dst``, links the port and the checkpoints beside them, and adds tiny
cells: the trained checkpoints at a 320-pixel detector, batches of 2,
8 slots, 1 s clips decoded with cv2, and a TrOCR of the published graph
at toy widths. The harness finds them by name as it finds the real ones.
"""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the detector at 320 still finds the clips' text, so that every layer
# has answers to check
TINY = {"batch_size": 2, "max_dets": 8, "detector_input_size": 320,
        "host_downscale": 640, "decode_backend": "cv2", "pipeline_depth": 2}
TOY_TROCR = dict(image_size=32, patch_size=16, enc_dim=32, enc_layers=1, enc_heads=2,
                 enc_mlp=64, dec_dim=32, dec_layers=1, dec_heads=2, dec_mlp=64,
                 vocab_size=200, max_len=6, dtype="float32")


def make_root(dst: str) -> str:
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("vtd_tpu_torch", "demo_models2"):
        os.symlink(os.path.join(REPO, name), os.path.join(dst, name))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    pb = os.path.join(dst, "portbench")
    for src, name, extra in (("dbnet_r50_crnn", "tiny_crnn", {}),
                             ("dbnet_r50_trocr_base", "tiny_trocr", {"rec_chunk": 4})):
        cfg = json.load(open(os.path.join(pb, "configs", src + ".json")))
        cfg["name"] = name
        cfg["pipeline"].update(TINY, **extra)
        if "trocr" in cfg["recognizer"]:
            cfg["recognizer"]["trocr"].update(TOY_TROCR)
            # the toy decoder runs in float32 on both sides (about 1e-6
            # apart), and its fp8 control, 6 steps over 200 ids, about
            # 0.017: the real cell's limit sits between its own readings
            cfg["limits"]["conf_rel_gap_mean"] = 0.005
        json.dump(cfg, open(os.path.join(pb, "configs", name + ".json"), "w"))
        bench["configs"].append({"name": name, "source": "tiny", "reduced": [],
                                 "file": f"portbench/configs/{name}.json", "why": "test"})
    for src, name, extra in (("clip720_text4", "tiny_closed", {}),
                             ("clips720_2s_open", "tiny_open", {"rate_per_s": 1.0})):
        t = json.load(open(os.path.join(pb, "traffic", src + ".json")))
        t["clip"]["seconds"] = 1.0 if name == "tiny_closed" else 0.4
        t.update(clips=2, warm_seconds=0.5, **extra)
        json.dump(t, open(os.path.join(pb, "traffic", name + ".json"), "w"))
    bench["workloads"] += [
        {"name": "tiny_crnn_c", "config": "tiny_crnn", "traffic": "tiny_closed",
         "chips": 1, "why": "test"},
        {"name": "tiny_trocr_c", "config": "tiny_trocr", "traffic": "tiny_closed",
         "chips": 1, "why": "test"},
        {"name": "tiny_crnn_o", "config": "tiny_crnn", "traffic": "tiny_open",
         "chips": 1, "why": "test"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny_crnn_c", "tiny_trocr_c"]
    # the open loop's metrics, for its tiny cell (no cell of the benchmark
    # runs the open loop yet)
    bench["end_to_end"] += [
        {"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["tiny_crnn_o"]}
        for n in ("clip_latency_p95_ms", "clip_latency_p50_ms")]
    bench["per_layer"].append(
        {"name": "batch_occupancy", "unit": "%", "better": "higher",
         "source": "program_counter", "layer": "engine",
         "moves": "clip_latency_p95_ms", "workloads": ["tiny_crnn_o"]})
    json.dump(bench, open(os.path.join(dst, "BENCHMARK.json"), "w"), indent=1)
    return dst
