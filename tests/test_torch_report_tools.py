"""The port's report tools (``vtd_tpu_torch.tools.update_report``,
``vtd_tpu_torch.tools.r5_promote``) against the reference's scripts.

``update_report``'s merge is held byte for byte against
``tools/update_report.py`` with both tools' ``run_engine`` replaced by
the same stand-in, so no pipeline runs (its engines are held against
``demo_models2/report.json`` in ``test_torch_drivers.py``, where they
share the verify clip's run). ``r5_promote`` is held against
``tools/r5_promote.py`` on a copy of ``demo_models2/trocr_r5``'s orbax
candidate: the same n/32, character accuracy within 1e-4 and exit code,
without ``--promote`` and with ``--promote --incumbent-score 32`` (which
returns before the reference copies anything into the repo). Then the
port's own: ``.pt`` candidates found, ranked and promoted to a ``--dest``
that loads (one that does not load skipped), a directory promoted, an
empty directory refused.
"""
import importlib.util
import json
import os
import re
import shutil
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = os.path.join(REPO, "demo_models2", "report.json")
R5 = os.path.join(REPO, "demo_models2", "trocr_r5")
CHAR_TOL = 1e-4


def load_reference(name: str):
    """``tools/<name>.py`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def engine_section(detector, recognizer, transformer, device="cpu"):
    """What ``run_engine`` returns, made from its arguments so that each
    engine's section differs from the committed one."""
    out = {
        "frames": 24 if transformer else 18,
        "detections": 71,
        "detected_texts": ["123", "HELL0", os.path.basename(recognizer)],
        "truth": ["HELLO", "WORLD", "123"],
        "exact_matches": 1,
        "clean": False,
    }
    if not transformer:
        out["avg_det_conf"] = 0.912
    return out


TROCR_LOG = [
    "2026-01-01 12:00:00 vtd_tpu: epoch 0: {'train_loss': 3.1}\n",
    json.dumps({"status": "success", "epochs_trained": 3}) + "\n",
    json.dumps({"best_model_path": "a/trocr_final", "final_loss": 0.5,
                "epochs_trained": 3, "heldout_exact_match_random8": "9/32",
                "heldout_char_accuracy_random8": 0.5}) + "\n",
    "not json\n",
    json.dumps({"best_model_path": "b/trocr_final", "final_loss": 0.02,
                "epochs_trained": 45, "heldout_exact_match_random8": "32/32",
                "heldout_char_accuracy_random8": 1.0,
                "history": [1, 2]}) + "\n",
    "done\n",
]


@pytest.mark.parametrize("log", ["none", "heldout", "no_heldout", "missing"])
def test_update_report_merge_is_the_references(log, tmp_path, monkeypatch,
                                               capsys):
    from vtd_tpu_torch.tools import update_report

    ref = load_reference("update_report")
    monkeypatch.setattr(ref, "run_engine", engine_section)
    monkeypatch.setattr(update_report, "run_engine", engine_section)

    with open(REPORT) as f:
        report = json.load(f)
    report["extra"] = {"kept": [1, 2.5, None], "name": "é"}
    src = tmp_path / "report.json"
    src.write_text(json.dumps(report, indent=2))
    ref_report = tmp_path / "ref_report.json"
    shutil.copy(src, ref_report)
    out = tmp_path / "out" / "report.json"

    args = []
    if log != "none":
        path = tmp_path / "trocr.log"
        if log == "heldout":
            path.write_text("".join(TROCR_LOG))
        elif log == "no_heldout":
            path.write_text("".join(TROCR_LOG[:2] + TROCR_LOG[3:4]))
        args = ["--trocr-log", str(path)]

    monkeypatch.setattr(sys, "argv",
                        ["update_report.py", "--report", str(ref_report),
                         *args])
    ref.main()
    ref_text = capsys.readouterr().out
    assert update_report.main(["--report", str(src), "--out", str(out),
                               "--device", "cpu", *args]) == 0
    text = capsys.readouterr().out

    assert out.read_bytes() == ref_report.read_bytes()
    # the port writes --out and leaves --report as it was
    assert json.loads(src.read_text()) == report
    assert text.splitlines()[0] == "device: cpu"
    assert text.splitlines()[1:] == ref_text.splitlines()
    merged = json.loads(out.read_text())
    assert merged["extra"] == report["extra"]
    assert merged["e2e"]["avg_det_conf"] == 0.912
    want_trocr = report["trocr"]
    if log == "heldout":
        want_trocr = {"checkpoint": "b/trocr_final", "final_loss": 0.02,
                      "epochs": 45, "heldout_exact_match_random8": "32/32",
                      "heldout_char_accuracy_random8": 1.0}
    assert merged["trocr"] == want_trocr


TABLE = re.compile(r"^(\S+): (\d+)/32 \(char ([0-9.]+)")


def table(text: str) -> dict:
    """{candidate's name: (n, char accuracy)} from a table's lines."""
    rows = {}
    for line in text.splitlines():
        m = TABLE.match(line)
        if m:
            rows[os.path.basename(m[1])] = (int(m[2]), float(m[3]))
    return rows


@pytest.fixture
def r5_copy(tmp_path):
    """A train dir holding a copy of the r5 run's orbax candidate and its
    config."""
    train = tmp_path / "trocr_r5"
    train.mkdir()
    shutil.copytree(os.path.join(R5, "trocr_final"), train / "trocr_final")
    shutil.copy(os.path.join(R5, "trocr_final_config.json"), train)
    return train


@pytest.mark.parametrize("args", [[], ["--promote", "--incumbent-score", "32"]],
                         ids=["score", "promote_not_better"])
def test_r5_promote_matches_reference(args, r5_copy, monkeypatch, capsys):
    from vtd_tpu_torch.tools import r5_promote

    ref = load_reference("r5_promote")
    # the reference scores in a subprocess that imports vtd_tpu
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO, *filter(None, [os.environ.get("PYTHONPATH")])]))
    monkeypatch.setattr(sys, "argv", ["r5_promote.py", str(r5_copy), *args])
    want_rc = ref.main()
    want = capsys.readouterr().out
    dest = r5_copy.parent / "dest" / "trocr"
    got_rc = r5_promote.main([str(r5_copy), *args, "--dest", str(dest),
                              "--device", "cpu"])
    got = capsys.readouterr().out

    assert got_rc == want_rc == (3 if args else 0)
    rows, want_rows = table(got), table(want)
    assert list(rows) == list(want_rows) == ["trocr_final"]
    assert rows["trocr_final"][0] == want_rows["trocr_final"][0] == 32
    assert abs(rows["trocr_final"][1] - want_rows["trocr_final"][1]) <= CHAR_TOL
    assert "crops stored" in got
    assert f"best: {r5_copy / 'trocr_final'} at 32/32" in got
    assert not dest.parent.exists()


def test_r5_promote_ranks_and_promotes_port_files(tmp_path, capsys):
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer
    from vtd_tpu_torch.tools import r5_promote
    from vtd_tpu_torch.tools.eval_trocr_ckpt import evaluate
    from vtd_tpu_torch.train.checkpoint import save_state_dict
    from vtd_tpu_torch.train.trocr_trainer import TrOCRTrainer, load_config

    cfg_path = os.path.join(R5, "trocr_final_config.json")
    cfg = load_config(cfg_path)
    train = tmp_path / "run"
    final = TrOCRTrainer({"init_from": os.path.join(R5, "trocr_final")},
                         model_config=cfg, device="cpu").build_model()
    save_state_dict(train / "trocr_final.pt", final)
    seeded = TrOCRTrainer({"seed": 7}, model_config=cfg,
                          device="cpu").build_model()
    save_state_dict(train / "trocr_autosave_a.pt", seeded)
    (train / "trocr_autosave_b.pt").write_bytes(b"cut off mid-save")
    shutil.copy(cfg_path, train)
    assert r5_promote.candidates(str(train)) == [
        str(train / f"{name}.pt")
        for name in ("trocr_final", "trocr_autosave_a", "trocr_autosave_b")]

    dest = tmp_path / "promoted" / "trocr"
    rc = r5_promote.main([str(train), "--promote", "--dest", str(dest),
                          "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0
    rows = table(text)
    assert list(rows) == ["trocr_final.pt", "trocr_autosave_a.pt"]
    assert rows["trocr_final.pt"] == (32, 1.0)
    assert rows["trocr_autosave_a.pt"][0] < 32
    # a candidate that does not load is reported and skipped
    assert f"{train / 'trocr_autosave_b.pt'}: eval failed: " in text
    assert f"promoted {train / 'trocr_final.pt'} -> {dest}.pt" in text
    assert sorted(os.listdir(dest.parent)) == ["trocr.pt",
                                               "trocr_config.json"]

    rec = TransformerRecognizer(model_path=f"{dest}.pt", device="cpu")
    assert rec.cfg == cfg
    want = final.state_dict()
    for k, v in rec.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    score = evaluate(f"{dest}.pt", f"{dest}_config.json", device="cpu")
    assert score["heldout_exact_match_random8"] == "32/32"


def test_r5_promote_promotes_a_directory_that_loads(r5_copy, tmp_path,
                                                    capsys):
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer
    from vtd_tpu_torch.tools import r5_promote

    dest = tmp_path / "promoted" / "text_recognizer_trocr"
    dest.mkdir(parents=True)
    (dest / "stale").write_text("from an earlier promotion")
    assert r5_promote.main([str(r5_copy), "--promote", "--dest", str(dest),
                            "--device", "cpu"]) == 0
    assert "promoted" in capsys.readouterr().out
    assert sorted(os.listdir(dest)) == sorted(
        os.listdir(r5_copy / "trocr_final"))
    assert (tmp_path / "promoted" / "text_recognizer_trocr_config.json"
            ).read_bytes() == (r5_copy / "trocr_final_config.json").read_bytes()
    got = TransformerRecognizer(model_path=str(dest), device="cpu")
    want = TransformerRecognizer(model_path=os.path.join(R5, "trocr_final"),
                                 device="cpu")
    assert got.cfg == want.cfg
    for k, v in got.model.state_dict().items():
        assert torch.equal(v, want.model.state_dict()[k]), k


def test_r5_promote_empty_dir_exits_1(tmp_path, monkeypatch, capsys):
    from vtd_tpu_torch.tools import r5_promote

    ref = load_reference("r5_promote")
    monkeypatch.setattr(sys, "argv", ["r5_promote.py", str(tmp_path)])
    assert ref.main() == 1
    want = capsys.readouterr().out
    assert r5_promote.main([str(tmp_path), "--promote", "--device",
                            "cpu"]) == 1
    assert capsys.readouterr().out == want == f"no checkpoints found in {tmp_path}\n"
