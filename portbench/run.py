"""The benchmark's command: one run of one cell on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. It exits 2 without a card (or with fewer
than the cell asks for), 3 if JAX or the JAX package got loaded, and 1 on
any other failure; otherwise the last line of standard output is the
result, a JSON object, and the numbers checked against the reference,
each beside its limit, are the last lines of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
_CACHE = os.path.join(ROOT, ".portbench_cache")
# the program's build and kernel caches stay inside the checkout, at
# fixed paths, so that only a checkout's first run builds
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(_CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_CACHE, "triton"))
os.environ["USE_FLAX"] = "0"
# a crash (a signal, as a segfault) prints every thread's stack to stderr
faulthandler.enable()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    chips = harness.Spec(ROOT).cell(args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result, out=None, err=None) -> None:
    out = out or sys.stdout
    err = err or sys.stderr
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


if __name__ == "__main__":
    sys.exit(main())
