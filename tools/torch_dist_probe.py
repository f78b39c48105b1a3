"""What ``torch.distributed`` offers on this machine's cards: the cards,
NCCL's availability and version, and one all-reduce of a CUDA tensor
with gloo over two ranks, NCCL over one rank, gloo over one rank, and
NCCL over two ranks on the first card (which NCCL refuses: "Duplicate
GPU detected").

Run on the card:  python3 tools/torch_dist_probe.py
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def allreduce_rank(rank: int) -> list:
    torch.cuda.set_device(0)
    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return x.tolist()


def main() -> None:
    from vtd_tpu_torch.core.mesh import spawn_ranks

    for query in (["-L"], ["--query-gpu=name,power.limit",
                           "--format=csv,noheader"]):
        print(subprocess.run(["nvidia-smi", *query], capture_output=True,
                             text=True).stdout.strip())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device_count "
          f"{torch.cuda.device_count()}, NCCL available "
          f"{dist.is_nccl_available()} version {torch.cuda.nccl.version()}, "
          f"gloo available {dist.is_gloo_available()}")
    for backend, world in (("gloo", 2), ("nccl", 1), ("gloo", 1),
                           ("nccl", 2)):
        t0 = time.perf_counter()
        try:
            out = spawn_ranks(allreduce_rank, (), world, device="cuda",
                              backend=backend)
            print(f"{backend} x{world} on cuda:0: all-reduce gives {out} "
                  f"({time.perf_counter() - t0:.1f} s with the spawn)")
        except RuntimeError as e:
            last = [ln for ln in str(e).splitlines() if ln.strip()][-1]
            print(f"{backend} x{world} on cuda:0: refused: {last}")


if __name__ == "__main__":
    main()
