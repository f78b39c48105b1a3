"""CPU tests of the benchmark's harness: names lead to files, a cell runs
end to end at a tiny size, the result line has the contract's keys, new
files alone add a metric and a mix, and the check fails the control and
each fault of the timed path."""
from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from .conftest_tiny import REPO, make_root

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    return json.load(open(os.path.join(REPO, "BENCHMARK.json")))


def test_every_name_leads_to_its_file():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/")
    used = set()
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert os.path.exists(os.path.join(REPO, "portbench", "traffic", w["traffic"] + ".json"))
        used.add(w["config"])
        assert len(w["why"]) <= 200
    assert used == set(configs)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert mod.UNIT == m["unit"] and callable(mod.read)
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for n in names + list(configs) + list(cells):
        assert NAME.match(n), n
    for w in b["workloads"]:  # each cell: setup_s, another end-to-end, a per-layer
        mine = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


def _run_in(root, cell, trace=False, patch=""):
    """One run of ``cell`` on the CPU in a fresh interpreter rooted at
    ``root`` (the harness's look for a card is skipped) -> (the last line
    of stdout as a dict, stderr)."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import torch; torch.set_num_threads(2)\n"
        f"{patch}\n"
        "from portbench import harness, run\n"
        f"r = harness.run({cell!r}, 2**31 + 11, 3.0, {trace}, root='.', device='cpu')\n"
        "run.emit(r)\n"
        "print('modules', sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'vtd_tpu'}), file=sys.stderr)\n"
    )
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.parametrize("cell", ["tiny_crnn_c", "tiny_trocr_c", "tiny_crnn_o"])
def test_cell_runs_end_to_end_on_the_cpu(tiny, cell):
    res, err = _run_in(tiny, cell)
    assert RESULT_KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    e2e = "frames_per_s" if cell.endswith("_c") else "clip_latency_p95_ms"
    assert res["metrics"][e2e]["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["run"]["samples_judged"] >= 1
    lines = err.strip().splitlines()
    assert "modules []" in lines[-1]
    assert [ln.split()[1] for ln in lines if ln.startswith("check ")] == list(res["checks"])
    assert res["correct"] is True, res["checks"]


def test_traced_run_on_the_cpu_reads_the_host_spans(tiny):
    res, _ = _run_in(tiny, "tiny_crnn_c", trace=True)
    assert res["metrics"]["decode_ms"]["value"] > 0
    assert res["metrics"]["dispatch_ms"]["value"] > 0
    assert "dbnet_ms" not in res["metrics"]  # no device trace on the CPU
    res, _ = _run_in(tiny, "tiny_crnn_o", trace=True)
    assert res["metrics"]["batch_occupancy"]["value"] > 0


def test_new_files_alone_add_a_metric_a_mix_and_a_loop(tiny, tmp_path):
    root = str(tmp_path)
    make_root(root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "metrics", "dummy_frames.py"), "w") as f:
        f.write('UNIT = "frames"\n\n\ndef read(ctx):\n'
                '    return float(ctx["counts"].get("valid_frames", 0)) or None\n')
    with open(os.path.join(pb, "loops", "dummy_loop.py"), "w") as f:
        f.write("from .closed import Driver as Closed\n\n\n"
                "class Driver(Closed):\n"
                "    def window(self, *a, **kw):\n"
                "        return dict(super().window(*a, **kw), dummy_loop=True)\n")
    t = json.load(open(os.path.join(pb, "traffic", "tiny_closed.json")))
    t["clip"]["texts"] = ["DUMMY", "MIX"]
    t["loop"] = "dummy_loop"
    json.dump(t, open(os.path.join(pb, "traffic", "dummy_mix.json"), "w"))
    b = json.load(open(os.path.join(root, "BENCHMARK.json")))
    b["workloads"].append({"name": "dummy_cell", "config": "tiny_crnn",
                           "traffic": "dummy_mix", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "dummy_frames", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "engine",
                           "moves": "frames_per_s", "workloads": ["dummy_cell"]})
    for m in b["end_to_end"]:
        if "frames_per_s" == m["name"]:
            m["workloads"].append("dummy_cell")
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))
    res, _ = _run_in(root, "dummy_cell", trace=True)
    assert res["metrics"]["dummy_frames"]["value"] > 0
    assert res["run"]["dummy_loop"] is True


FAULTS = {
    # half of the batch left out: the detector's maps of its second half zeroed
    "half_batch": (  # (the patch, the number that must catch it)
        "import vtd_tpu_torch.runtime.detector as d\n"
        "_p = d.TextDetector.probability\n"
        "def prob(self, x):\n"
        "    y = _p(self, x).clone(); y[y.shape[0] // 2:] = 0; return y\n"
        "d.TextDetector.probability = prob\n", "prob_max_abs"),
    # a token altered where it is produced: every CTC step's id moved by one
    "token": (
        "import vtd_tpu_torch.runtime.pipeline as pl\n"
        "_c = pl.ctc_greedy_decode_arrays\n"
        "def ctc(l):\n"
        "    r = dict(_c(l)); r['ids'] = (r['ids'] % 95) + 1; return r\n"
        "pl.ctc_greedy_decode_arrays = ctc\n", "logit_gap_max"),
    # an answer altered where it is produced: the host's transcripts
    "answer": (
        "import vtd_tpu_torch.runtime.pipeline as pl\n"
        "_t = pl.ids_to_text\n"
        "pl.ids_to_text = lambda ids, emit: [s + 'x' for s in _t(ids, emit)]\n",
        "answer_mismatch"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_reads_not_correct(tiny, fault):
    patch, number = FAULTS[fault]
    res, _ = _run_in(tiny, "tiny_crnn_c", patch=patch)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


TROCR_FAULTS = {
    # a token altered where it is produced
    "token": ("t = t.clone(); t[:, 0] = (t[:, 0] + 7) % 200", "logit_gap_max"),
    # the confidences of a decoder that runs off its stated precision
    "confidence": ("c = c * 1.5", "conf_rel_gap_mean"),
}


@pytest.mark.parametrize("fault", sorted(TROCR_FAULTS))
def test_a_broken_trocr_decoder_reads_not_correct(tiny, fault):
    change, number = TROCR_FAULTS[fault]
    patch = ("import vtd_tpu_torch.runtime.trocr_runtime as tr\n"
             "_g = tr.TransformerRecognizer.generate\n"
             "def gen(self, crops):\n"
             f"    t, c = _g(self, crops); {change}\n"
             "    return t, c\n"
             "tr.TransformerRecognizer.generate = gen\n")
    res, _ = _run_in(tiny, "tiny_trocr_c", patch=patch)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny_crnn_c", "tiny_trocr_c"])
def test_the_control_and_the_planted_faults_read_not_correct(tiny, cell):
    code = (
        "import sys, json; sys.path.insert(0, '.')\n"
        "import torch; torch.set_num_threads(2)\n"
        "from portbench import calibrate\n"
        f"calibrate.readings({cell!r}, [2**31 + 21, 5], 2.0, root='.', "
        "device='cpu')\n")
    env = dict(os.environ, PYTHONPATH=tiny)
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny, capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    config = "tiny_crnn" if "crnn" in cell else "tiny_trocr"
    limits = json.load(open(os.path.join(tiny, "portbench", "configs",
                                         config + ".json")))["limits"]
    for line in p.stdout.strip().splitlines():
        row = json.loads(line)
        assert row["correct"] is True, row["program"]
        assert all(row["program"][k] <= max(limits[k], 1e-4) for k in limits
                   if k not in ("bgr_max_abs",)), row
        # the recognizer alone in fp8 fails a recognizer's number
        assert set(row["control"]["recognizer"]["fails"]) & {
            "logit_max_abs", "logit_gap_max", "conf_rel_gap_mean"}, row["control"]
        assert "post_iou_gap" in row["faults"]["box_shift"]["fails"], row["faults"]
        assert "logit_gap_max" in row["faults"]["token"]["fails"], row["faults"]
