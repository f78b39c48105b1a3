"""The reference's ``tests/test_broker.py``, run against ``vtd_tpu_torch``.

``test_two_process_jax_distributed_init`` meets a recorded divergence:
its child processes join through ``jax.distributed.initialize``. The port
case of the same name runs the same two-process scenario through the
port's ``init_distributed`` (a gloo group, ``device="cpu"``), and checks
that the port's pipeline refuses to be built without ``device="cpu"``
where CUDA is absent.
"""
import os
import subprocess
import sys

import pytest
import torch
from torch_ref_cases import cases, load

globals().update(cases(load("test_broker")))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DIST_WORKER_SRC = r"""
import sys
import torch
import torch.distributed as dist
from vtd_tpu_torch.core import mesh

coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert mesh.init_distributed(coord, nproc, pid, device="cpu") is True
assert mesh.init_distributed(coord, nproc, pid, device="cpu") is True
m = mesh.make_mesh(n_data=4, device="cpu")  # two entries a process
start, size = mesh.local_batch_slice(8, m)
total = torch.tensor([pid + 1.0])
dist.all_reduce(total)
rows = m.shape[mesh.DATA_AXIS]
print("SLICE", pid, dist.get_world_size(), rows,
      rows // dist.get_world_size(), start, size, int(total), flush=True)
dist.destroy_process_group()
"""


def test_two_process_jax_distributed_init(tmp_path):
    """Two processes join one group through ``init_distributed`` (twice:
    idempotent), share a 4-entry mesh and a sum, and ``local_batch_slice``
    hands each a disjoint contiguous half of the global batch."""
    from vtd_tpu_torch.core.mesh import free_port
    from vtd_tpu_torch.runtime import VideoTextPipeline

    coord = f"127.0.0.1:{free_port()}"
    script = str(tmp_path / "dist_worker.py")
    with open(script, "w") as f:
        f.write(DIST_WORKER_SRC)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, script, coord, "2", str(k)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for k in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    slices = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("SLICE"):
                _, pid, ws, rows, local, start, size, total = line.split()
                assert (ws, rows, local, total) == ("2", "4", "2", "3"), out
                slices[int(pid)] = (int(start), int(size))
    assert slices == {0: (0, 4), 1: (4, 4)}, (slices, outs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            VideoTextPipeline(use_transformer_ocr=False, batch_size=4,
                              max_dets=16, detector_input_size=160)
