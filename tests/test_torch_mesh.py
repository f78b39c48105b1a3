"""The port's mesh, data-axis rules, process groups and collectives
(``vtd_tpu_torch.core.mesh``, ``parallel/sharding.py``,
``parallel/collectives.py``) on the CPU, against ``vtd_tpu.core.mesh`` on
the reference's 8-device host mesh where both have the function.

Spawned groups are gloo on localhost, each joined and left inside its
test. The gradient of a loss built from all-reduced sums, averaged over
2 ranks, equals the full batch's gradient to 1e-12 (float64).
"""
import os
import time
from unittest import mock

import numpy as np
import pytest
import torch

import torch_mesh_tasks

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture
def no_group():
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_make_mesh_shapes_match_reference():
    import jax

    from vtd_tpu.core.mesh import make_mesh as ref_make_mesh
    from vtd_tpu_torch.core.mesh import Mesh, make_mesh

    assert len(jax.devices()) == 8
    for kw in ({}, {"n_data": 4, "n_model": 2}, {"n_data": 8},
               {"n_model": 4}):
        ref = ref_make_mesh(**kw)
        mesh = make_mesh(devices=[CPU] * 8, **kw)
        assert isinstance(mesh, Mesh)
        assert mesh.shape == dict(ref.shape)
        assert mesh.devices.shape == ref.devices.shape
        assert mesh.data_devices() == [CPU] * ref.shape["data"]
    for kw in ({"n_data": 3, "n_model": 2}, {"n_data": 9}):
        with pytest.raises(ValueError) as want:
            ref_make_mesh(**kw)
        with pytest.raises(ValueError) as got:
            make_mesh(devices=[CPU] * 8, **kw)
        assert str(got.value) == str(want.value)
    # without devices: n_data * n_model CPU entries when the CPU is asked
    # for, and every visible card otherwise (none here: it raises)
    assert make_mesh(n_data=2, device="cpu").shape == {"data": 2, "model": 1}
    assert make_mesh(device="cpu").devices.tolist() == [[CPU]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(devices=["cuda:0"])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_batch_slice(world):
    from vtd_tpu_torch.core.mesh import local_batch_slice, make_mesh

    mesh = make_mesh(n_data=4, device="cpu")
    slices = [local_batch_slice(16, mesh, rank=r, world_size=world)
              for r in range(world)]
    rows = 16 // world
    assert slices == [(r * rows, rows) for r in range(world)]
    # outside any group the process owns every row
    assert local_batch_slice(16, mesh) == (0, 16)
    with pytest.raises(ValueError, match="divisible"):
        local_batch_slice(10, mesh, rank=0, world_size=world)
    with pytest.raises(ValueError, match="shared out"):
        local_batch_slice(24, make_mesh(n_data=3, device="cpu"), rank=0,
                          world_size=2)


def test_pad_and_active_mesh_match_reference():
    from vtd_tpu.core import mesh as ref
    from vtd_tpu_torch.core import mesh as port

    for n, m in ((5, 4), (8, 4), (0, 3), (1, 8)):
        assert port.pad_to_multiple(n, m) == ref.pad_to_multiple(n, m)
    mesh = port.make_mesh(n_data=2, device="cpu")
    assert port.get_active_mesh() is None
    with port.active_mesh(mesh) as active:
        assert active is mesh and port.get_active_mesh() is mesh
    assert port.get_active_mesh() is None


def test_batch_sharding_and_replicas():
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.parallel.sharding import (
        batch_sharding, infer_param_shardings, row_blocks, shard_variables,
    )
    from vtd_tpu_torch.runtime import TextDetector

    x = np.arange(24).reshape(8, 3)
    mesh = make_mesh(n_data=4, device="cpu")
    parts = batch_sharding(x, mesh)
    assert [p.tolist() for p in parts] == [x[2 * i:2 * i + 2].tolist()
                                          for i in range(4)]
    assert len(batch_sharding(torch.zeros(6, 2), 3)) == 3
    with pytest.raises(ValueError, match="divisible"):
        batch_sharding(x[:6], mesh)
    # regrouping 8 rows from 2 blocks into 4, and from 4 into 2
    assert [row_blocks(8, 2, 4, j) for j in range(4)] == [
        [(0, 0, 2)], [(0, 2, 4)], [(1, 0, 2)], [(1, 2, 4)]]
    assert row_blocks(8, 4, 2, 1) == [(2, 0, 2), (3, 0, 2)]
    assert row_blocks(6, 2, 3, 1) == [(0, 2, 3), (1, 0, 1)]
    # the model axis: a wide kernel split by its output channels
    wide = torch.nn.Conv2d(256, 512, 1)
    assert infer_param_shardings(
        wide, make_mesh(n_data=4, n_model=2, device="cpu")) == {
            "weight": 0, "bias": None}

    det = TextDetector(input_size=64, max_dets=4, device="cpu")
    reps = shard_variables(det, make_mesh(n_data=3, device="cpu"))
    assert reps[0] is det  # the first entry on the model's own device
    assert len({id(r.model) for r in reps}) == 3  # its own copy each
    for r in reps[1:]:
        for (k, a), b in zip(det.model.state_dict().items(),
                             r.model.state_dict().values()):
            assert torch.equal(a, b), k


def test_replica_runs_in_its_own_thread():
    import threading

    from vtd_tpu_torch.parallel.sharding import Replica, gather

    reps = [Replica(CPU) for _ in range(2)]
    try:
        futs = [r.submit(lambda rep, i: (rep, i, threading.get_ident(),
                                         torch.is_inference_mode_enabled()),
                         i) for i, r in enumerate(reps) for _ in range(2)]
        got = gather(futs)
    finally:
        for r in reps:
            r.close()
    assert [(g[0], g[1]) for g in got] == [(reps[0], 0), (reps[0], 0),
                                           (reps[1], 1), (reps[1], 1)]
    idents = [g[2] for g in got]
    assert idents[0] == idents[1] != idents[2] == idents[3]
    assert threading.get_ident() not in idents
    assert all(g[3] for g in got)
    assert not any(t.name.startswith("replica-")
                   for t in threading.enumerate())


def test_init_distributed_is_a_no_op_without_settings(no_group):
    from vtd_tpu_torch.core.mesh import init_distributed

    with mock.patch.dict(os.environ):
        for var in ("VTD_COORDINATOR_ADDRESS", "VTD_NUM_PROCESSES",
                    "VTD_PROCESS_ID"):
            os.environ.pop(var, None)
        assert init_distributed(device="cpu") is False
        assert not torch.distributed.is_initialized()
        os.environ["VTD_NUM_PROCESSES"] = "2"
        with pytest.raises(ValueError, match="VTD_COORDINATOR_ADDRESS"):
            init_distributed(device="cpu")
        del os.environ["VTD_NUM_PROCESSES"]
        os.environ["VTD_COORDINATOR_ADDRESS"] = "127.0.0.1:1"
        with pytest.raises(ValueError, match="VTD_NUM_PROCESSES"):
            init_distributed(device="cpu")
        os.environ["VTD_NUM_PROCESSES"] = "2"
        with pytest.raises(ValueError, match="VTD_PROCESS_ID"):
            init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_init_distributed_world_of_one(no_group):
    from vtd_tpu_torch.core.mesh import free_port, init_distributed

    with mock.patch.dict(os.environ, {
            "VTD_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
            "VTD_NUM_PROCESSES": "1"}):
        os.environ.pop("VTD_PROCESS_ID", None)
        assert init_distributed(device="cpu") is True
        dist = torch.distributed
        assert dist.is_initialized()
        assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
        assert dist.get_backend() == "gloo"
        group = dist.distributed_c10d._get_default_group()
        assert init_distributed(device="cpu") is True  # idempotent
        assert dist.distributed_c10d._get_default_group() is group
        t = torch.tensor([2.0])
        dist.all_reduce(t)
        assert float(t) == 2.0


def test_spawn_ranks_returns_every_rank():
    from vtd_tpu_torch.core.mesh import spawn_ranks

    got = spawn_ranks(torch_mesh_tasks.echo_rank, (1.5,), 2, device="cpu")
    assert got == [{"rank": r, "world": 2, "backend": "gloo", "sum": 4.5}
                   for r in range(2)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spawn_ranks(torch_mesh_tasks.echo_rank, (1.0,), 1)


def test_a_failing_rank_fails_the_run_without_a_hang():
    """Rank 1 raises while rank 0 waits in an all-reduce: the launcher
    stops rank 0 at once (the group's own timeout is 600 s)."""
    import multiprocessing

    from vtd_tpu_torch.core.mesh import spawn_ranks

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        spawn_ranks(torch_mesh_tasks.failing_rank, (), 2, device="cpu")
    assert "rank 1 fails on purpose" in str(err.value)
    assert time.perf_counter() - t0 < 60
    assert multiprocessing.active_children() == []


def test_global_loss_gradient_averaged_over_ranks():
    """The toy's loss takes BatchNorm-style statistics and a Dice-style
    ratio over every row. Two ranks, each with half the rows: every rank
    holds the full batch's loss; the all-reduce's backward gives each rank
    2x its own share of the gradient, and the average over the ranks is
    the full batch's gradient (float64, to 1e-12). Summing instead of
    averaging would double it."""
    from vtd_tpu_torch.core.mesh import spawn_ranks

    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 5))
    w = rng.normal(size=(5, 3))
    ranks = spawn_ranks(torch_mesh_tasks.global_stats_rank, (x, w), 2,
                        device="cpu")
    param = torch.nn.Parameter(torch.from_numpy(w.copy()))
    loss = torch_mesh_tasks.toy_loss(torch.from_numpy(x), param)
    loss.backward()
    full = param.grad.numpy()
    for r in ranks:
        assert abs(r["loss"] - float(loss.detach())) <= 1e-12
        np.testing.assert_allclose(r["grad"], full, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ranks[0]["own_grad"] + ranks[1]["own_grad"],
                               2 * full, rtol=0, atol=1e-12)
