"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles into its
own shared library under ``.build/`` (listed in ``.gitignore``), named
after a hash of the source so that an edited kernel never loads a stale
build. Nothing is compiled at import time: the first wrapper call on a
CUDA tensor builds what it needs, and ``build_all`` builds every source
at once (one ``nvcc`` process per file, all started together).
``kernel`` declares a library's C entry point once and launches it the
one way every wrapper does: on the tensor's device, on the current
stream, a non-zero return raised.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from vtd_tpu_torch/csrc at first use"
    )


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, nvcc: str):
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build_all(names: List[str] | None = None) -> Dict[str, str]:
    """Compile every listed source (default: all of ``csrc/*.cu``) in
    parallel and load each library. Returns {name: compiler output}."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        todo = [n for n in names if n not in _libs]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            jobs = {}
            for n in todo:
                if _target(n).exists():
                    continue
                jobs[n] = _start(n, nvcc)
            failed = []
            for n, (proc, tmp, out) in jobs.items():
                log, _ = proc.communicate()
                _logs[n] = log
                if proc.returncode != 0:
                    failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, out)
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
            for n in todo:
                _libs[n] = ctypes.CDLL(str(_target(n)))
                _logs.setdefault(n, "(cached build)")
        return {n: _logs.get(n, "") for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def kernel(name: str, symbol: str, argtypes: list) -> Callable[..., None]:
    """``symbol`` of ``csrc/<name>.cu`` as ``launch(device_index, *args)``:
    built, loaded and declared (``argtypes`` and a trailing stream
    pointer, an int return) at its first call, then called with the
    device made current only where it is not, and the current stream's
    raw pointer (a ``torch.cuda.Stream`` object costs several µs of host
    time a call, as much as a kernel launch). A non-zero return raises
    ``RuntimeError``, named after ``symbol`` without its ``vtd_``."""
    what = symbol.removeprefix("vtd_")
    fn = None

    def launch(device_index: int, *args) -> None:
        nonlocal fn
        if fn is None:  # first use: build, load, declare the C signature
            f = getattr(load(name), symbol)
            f.argtypes = [*argtypes, ctypes.c_void_p]
            f.restype = ctypes.c_int
            fn = f
        if device_index != torch._C._cuda_getDevice():
            with torch.cuda.device(device_index):
                return launch(device_index, *args)
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")

    return launch
