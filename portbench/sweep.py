"""The rate sweep that fixes an open-loop mix's rate, run once by hand.

    python3 -m portbench.sweep --workload <open cell> --rates 4,6,8,10 \\
        [--seconds 15] [--seed 1]

One process, the pipeline built once; at each rate the mix's window runs
as the benchmark runs it, and one JSON line gives the latency
percentiles, the clips due and missed, the engine's occupancy and how late
the generator ran. The knee is the highest rate whose clips all resolve
and whose p95 has not started to climb with the rate; the mix's file
holds about four fifths of it. No cell of ``BENCHMARK.json`` runs an
open loop yet: this, ``loops/open.py``, ``metrics/batch_occupancy.py`` and
``traffic/clips720_2s_open.json`` wait for the cell that will.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import clips as clipgen
    from portbench.harness import Spec, build_pipeline, driver
    from portbench.taps import Taps

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    inputs = clipgen.make(cell["traffic"], traffic["clip"], traffic["clips"], args.seed,
                          traffic.get("warm_seconds", 2),
                          root=os.path.join(ROOT, ".portbench_cache", "clips"))
    pipe = build_pipeline(cfg, traffic, args.device, ROOT)
    for rate in [float(r) for r in args.rates.split(",")]:
        t = dict(traffic, rate_per_s=rate)
        taps = Taps(pipe, args.seed, 0, False).install()
        loop = driver(t, pipe, inputs, args.seed, sys.stderr)
        loop.warm()
        w = loop.window(args.seconds, taps, None, 0.0, 0.0)
        loop.close()
        occ = (100.0 * taps.counts["valid_frames"]
               / max(1, w["engine_batches"] * pipe.batch_size))
        taps.uninstall()
        print(json.dumps({"rate_per_s": rate, **w["metrics"], "attempted": w["attempted"],
                          "failed": w["failed"], "occupancy": occ,
                          "late_ms_max": w["generator_late_ms_max"]}), flush=True)
    pipe.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
