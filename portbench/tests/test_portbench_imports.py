"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program. Top-level names are
compared whole: ``vtd_tpu_torch`` is not ``vtd_tpu``."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
FORBIDDEN = {"jax", "jaxlib", "flax", "vtd_tpu"}


def _sources(sub=""):
    for root, dirs, files in os.walk(os.path.join(PB, sub)):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_names_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_top_imports(path)) & FORBIDDEN, path


def test_the_reference_names_nothing_of_the_program():
    for path in _sources("reference"):
        assert "vtd_tpu_torch" not in set(_top_imports(path)), path


def _loaded(modules):
    code = ("import sys, json, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    import json

    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def _modules(sub=""):
    out = []
    for path in _sources(sub):
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        out.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return out


@pytest.mark.parametrize("what", ["harness", "reference"])
def test_what_a_run_loads(what):
    if what == "harness":
        mods = _modules() + ["vtd_tpu_torch.runtime", "vtd_tpu_torch.runtime.engine"]
        assert not _loaded(mods) & FORBIDDEN
    else:
        loaded = _loaded(_modules("reference"))
        assert not loaded & FORBIDDEN
        assert "vtd_tpu_torch" not in loaded
