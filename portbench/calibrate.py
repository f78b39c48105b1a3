"""Readings for the limits: the program's, the control's and the planted
faults', seed by seed, on the benchmark's own path.

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,13 \\
        [--seconds 8]

For every seed one run of the cell (``harness.run``, as the benchmark
runs it, with a short window) with ``calibrate=True``: the window's
sampled batches are judged as the run judges them, then with the control
in the program's place one layer at a time (``reference/control.py``) and
with each fault of ``reference/faults.py`` planted in them. One JSON line
a seed on standard output. It needs a card, as the benchmark does;
``--device cpu`` runs it here at whatever size the cell has.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"


def readings(cell_name: str, seeds, seconds: float, *, root: str = ROOT,
             device: str = "cuda", out=sys.stdout):
    import gc

    from portbench import harness

    rows = []
    for seed in seeds:
        r = harness.run(cell_name, seed, seconds, False, root=root, device=device,
                        calibrate=True)
        row = {"seed": seed, "correct": r["correct"], **r["calibration"],
               "metrics": {k: m["value"] for k, m in r["metrics"].items()},
               "run": r["run"], "card": r["card"]}
        rows.append(row)
        print(json.dumps(row), file=out, flush=True)
        del r
        gc.collect()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    readings(args.workload, seeds, args.seconds, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
