"""Run a test file of the JAX package against ``vtd_tpu_torch``.

``load(name)`` reads ``tests/<name>.py``, applies the file's own textual
replacements (each must match), rewrites every ``vtd_tpu`` to
``vtd_tpu_torch`` (in imports and strings alike: ``monkeypatch``
targets, task module names, the code of child processes) and executes
the result as a module whose ``__file__`` is the reference file. A shim
``tests/test_torch_ref_<name>.py`` puts the module's tests and fixtures
into its own namespace, where pytest collects them; a case that meets a
recorded divergence of the port is replaced there by a port case of the
same name.

So the port is held to the reference's cases as they stand, and a change
to either package's copy of the code they test fails a case.
"""
import os
import re
import types

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str, replace=()) -> types.ModuleType:
    path = os.path.join(HERE, f"{name}.py")
    with open(path) as f:
        src = f.read()
    for old, new in replace:
        if old not in src:
            raise ValueError(f"{name}.py no longer holds {old!r}")
        src = src.replace(old, new)
    src = re.sub(r"\bvtd_tpu\b", "vtd_tpu_torch", src)
    module = types.ModuleType(f"torch_ref_{name}")
    module.__file__ = path
    exec(compile(src, path, "exec"), module.__dict__)
    return module


def cases(module: types.ModuleType) -> dict:
    """The module's public names: its tests, fixtures and helpers (what a
    shim's ``globals().update`` takes)."""
    return {k: v for k, v in vars(module).items() if not k.startswith("__")}
