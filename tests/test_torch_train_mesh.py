"""Data-parallel DBNet training of the port (``ModelTrainer(mesh=...)``,
``make_train_step(group=...)``, ``train-detector --mesh``) on the CPU.

One spawn of 2 gloo ranks (module fixture) runs one step of a 64x64 DBNet
(flax's init carried across by ``convert.dbnet_from_jax``) on a global
batch of 4, each rank on its 2 frames, in float32 and in float64. Against
the 1-process step on the same batch and weights:

  * loss and its parts: rtol 1e-5 (float32) and 1e-6 (float64, where the
    DB loss itself still sums in float32);
  * the gradient norm: float64 rtol 1e-7, and float64 gradients tensor by
    tensor within 1e-6 of their norm; float32 within 1e-4 plus 10x the
    port's own float32 rounding of the norm (its 1-process float32 step
    against its float64 step; at flax's init train-mode BatchNorm over
    8-32 samples a channel amplifies rounding, see
    ``tests/test_torch_train.py``);
  * every parameter after AdamW: AdamW's first update is
    lr * g / (|g| + 1e-8), so an element whose gradient is within rounding
    of 0 may move anywhere in +-lr. Every element is within 2 * lr + 2
    ulps; an element whose gradient is live (|g| above 1e-6 and above 100x
    the float32 rounding of both float32 steps there, each against its
    float64 twin) within 1e-3 * lr + 2 ulps;
  * BatchNorm running statistics: float64 within 1e-10; float32 within the
    bound ``tests/test_torch_train.py`` holds one device to (1e-5 of the
    norm plus 10x the port's float32 rounding);
  * both ranks hold the same parameters (sums bit-equal).

The same ranks' float32 step against ``vtd_tpu``'s ``make_train_step`` on
a 2-device JAX mesh (one GSPMD program over the same batch): loss and aux
rtol 1e-5, the running statistics as above, every parameter within
2 * lr + 2 ulps, and at most 1e-4 of the live elements (the reference's
own float32 rounding, which the port cannot measure, flips a few signs)
beyond 1e-3 * lr + 2 ulps.
"""
import json
import os

import numpy as np
import pytest
import torch

import torch_mesh_tasks

torch.set_num_threads(2)

LR = 1e-4


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Flax-initialised weights, the 2-rank results (rank 0's full state
    and gradients, each rank's aux and parameter sums), the 1-process
    float32 / float64 steps, and the reference's step on a 2-device
    mesh."""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.core.mesh import make_mesh as ref_make_mesh
    from vtd_tpu.models.dbnet import DBNet as RefDBNet
    from vtd_tpu.parallel.sharding import batch_sharding
    from vtd_tpu.train.trainer import create_train_state, make_train_step
    from vtd_tpu_torch.convert import dbnet_from_jax
    from vtd_tpu_torch.core.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("dp")
    images, targets = torch_mesh_tasks.dbnet_batch()
    state = create_train_state(RefDBNet(dtype=jnp.float32),
                               jax.random.PRNGKey(0), images.shape,
                               learning_rate=LR, weight_decay=1e-5)
    params = jax.device_get(state["params"])
    stats = jax.device_get(state["batch_stats"])
    weights = dbnet_from_jax({"params": params, "batch_stats": stats})
    torch.save(weights, tmp / "w.pt")

    ranks = spawn_ranks(torch_mesh_tasks.dbnet_step_rank,
                        (str(tmp / "w.pt"), str(tmp / "rank0.pt")), 2,
                        device="cpu")
    two = torch.load(tmp / "rank0.pt")
    one = {}
    for dtype in (torch.float32, torch.float64):
        net, aux = torch_mesh_tasks.dbnet_step(weights, images, targets,
                                               dtype)
        one[str(dtype).split(".")[-1]] = torch_mesh_tasks.step_result(
            net, aux)

    mesh = ref_make_mesh(n_data=2, devices=jax.devices()[:2])
    new_params, new_stats, _, aux = make_train_step(
        state["model"], state["tx"])(
        state["params"], state["batch_stats"], state["opt_state"],
        jax.device_put(images, batch_sharding(mesh, 4)),
        {k: jax.device_put(v, batch_sharding(mesh, 3))
         for k, v in targets.items()})
    ref = dbnet_from_jax({"params": jax.device_get(new_params),
                          "batch_stats": jax.device_get(new_stats)})
    return {"ranks": ranks, "two": two, "one": one, "weights": weights,
            "ref": ref, "ref_aux": {k: float(v) for k, v in aux.items()}}


def _norm(grads):
    return float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads.values())))


def _live(steps):
    """Elements whose gradient AdamW's first step follows by its sign in
    both float32 steps: above 1e-6 and above 100x each float32 step's
    rounding there (against its float64 twin)."""
    one, two = steps["one"], steps["two"]
    out = {}
    for k, g in one["float64"]["grads"].items():
        g = g.double()
        n1 = (one["float32"]["grads"][k].double() - g).abs()
        n2 = (two["float32"]["grads"][k].double()
              - two["float64"]["grads"][k].double()).abs()
        out[k] = (g.abs() > 1e-6) & (g.abs() > 100 * n1) & (g.abs() > 100 * n2)
    return out


def _assert_params(got, want, live, weights, stray=0.0):
    """Every element within 2 * lr + 2 ulps; live elements within
    1e-3 * lr + 2 ulps, but for at most ``stray`` of them."""
    n_live = n_far = 0
    for k in weights:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        g, w = got[k].double(), want[k].double()
        d = (g - w).abs()
        ulp = torch.from_numpy(
            2 * np.spacing(np.abs(w.float().numpy())).astype(np.float64))
        assert (d <= 2 * LR + ulp).all(), (k, float(d.max()))
        m = live[k]
        n_far += int((d[m] > 1e-3 * LR + ulp[m]).sum())
        n_live += int(m.sum())
    assert n_live > 0.2 * sum(v.numel() for v in live.values())
    assert n_far <= stray * n_live, (n_far, n_live)


def _stats(state):
    return {k: v for k, v in state.items()
            if k.endswith(("running_mean", "running_var"))}


def _assert_stats32(got, want, steps):
    """float32 running statistics against ``want``: 1e-5 of the norm plus
    10x the port's float32 rounding (1-process float32 against float64)."""
    s32 = _stats(steps["one"]["float32"]["state"])
    s64 = _stats(steps["one"]["float64"]["state"])
    for k, s in _stats(got).items():
        w = want[k].double().numpy()
        err = np.linalg.norm(s.double().numpy() - w)
        noise = np.linalg.norm(s32[k].double().numpy() - s64[k].numpy())
        assert err <= 1e-5 * (np.linalg.norm(w) + np.sqrt(w.size)) + \
            10 * noise, (k, err, noise)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_rank_step_equals_one_process_step(steps, dtype):
    two, one = steps["two"][dtype], steps["one"][dtype]
    tight = dtype == "float64"
    assert set(two["aux"]) == set(one["aux"]) == {
        "loss", "prob_loss", "thresh_loss", "dice_loss"}
    for k, v in one["aux"].items():
        np.testing.assert_allclose(two["aux"][k], v,
                                   rtol=1e-6 if tight else 1e-5, err_msg=k)
    norm = _norm(one["grads"])
    if tight:
        np.testing.assert_allclose(_norm(two["grads"]), norm, rtol=1e-7)
        for k, g in one["grads"].items():
            err = float((two["grads"][k] - g).norm())
            assert err <= 1e-6 * float(g.norm()) + 1e-12, (k, err)
        for k, s in _stats(one["state"]).items():
            np.testing.assert_allclose(two["state"][k].numpy(), s.numpy(),
                                       rtol=0, atol=1e-10, err_msg=k)
    else:
        noise = abs(norm - _norm(steps["one"]["float64"]["grads"]))
        assert abs(_norm(two["grads"]) - norm) <= 1e-4 * norm + 10 * noise
        _assert_stats32(two["state"], one["state"], steps)
    _assert_params(two["state"], one["state"], _live(steps),
                   steps["weights"])
    for k, v in two["state"].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(one["state"][k]) == 1


def test_ranks_hold_the_same_state(steps):
    r0, r1 = steps["ranks"]
    assert (r0["rows"], r1["rows"]) == ([0, 2], [2, 2])
    for dtype in ("float32", "float64"):
        assert r0[dtype]["aux"] == r1[dtype]["aux"]
        assert r0[dtype]["params"] == r1[dtype]["params"]
        assert r0[dtype]["aux"] == steps["two"][dtype]["aux"]


def test_two_rank_step_matches_reference_mesh(steps):
    two = steps["two"]["float32"]
    for k, v in steps["ref_aux"].items():
        np.testing.assert_allclose(two["aux"][k], v, rtol=1e-5, err_msg=k)
    _assert_params(two["state"], steps["ref"], _live(steps),
                   steps["weights"], stray=1e-4)
    _assert_stats32(two["state"], steps["ref"], steps)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cli_train_detector_mesh(tmp_path, capsys):
    """``--mesh 2x1 --device cpu`` spawns 2 gloo ranks; rank 0 writes the
    one checkpoint, which TextDetector loads."""
    from vtd_tpu_torch.__main__ import main
    from vtd_tpu_torch.runtime import TextDetector

    assert main(["train-detector", "--synthetic", "--n-samples", "6",
                 "--image-size", "64", "--epochs", "1", "--batch-size", "4",
                 "--device", "cpu", "--mesh", "2x1", "--checkpoint-dir",
                 str(tmp_path / "dp")]) == 0
    res = _last_json(capsys.readouterr().out)
    assert res["status"] == "success", res
    assert os.path.dirname(res["best_model_path"]) == str(tmp_path / "dp")
    assert os.listdir(tmp_path / "dp") == [
        os.path.basename(res["best_model_path"])]
    det = TextDetector(model_path=res["best_model_path"], input_size=64,
                       device="cpu")
    prob = det.probability(torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
    assert prob.shape == (1, 64, 64) and bool(torch.isfinite(prob).all())
    assert np.isfinite(res["best_val_loss"])


def test_cli_mesh_failures(tmp_path, capsys):
    """A mesh with an empty axis is refused; a 4x2 mesh trains only as 4
    ranks of a group; ranks that fail make the command fail (exit 1, the
    rank's error in the result)."""
    from vtd_tpu_torch.__main__ import main
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.train.trainer import ModelTrainer, TextDetectionDataset

    with pytest.raises(ValueError, match="bad mesh"):
        main(["train-detector", "--mesh", "4x0", "--device", "cpu"])
    ds4 = TextDetectionDataset(np.zeros((4, 64, 64, 3), np.float32), {
        "probability_map": np.zeros((4, 64, 64), np.float32),
        "threshold_map": np.zeros((4, 64, 64), np.float32)})
    out = ModelTrainer({"checkpoint_dir": str(tmp_path / "x42"),
                        "batch_size": 4},
                       mesh=make_mesh(n_data=4, n_model=2, device="cpu"),
                       device="cpu").train(DBNet(dtype=torch.float32), ds4,
                                           ds4)
    assert out["status"] == "failed" and "one process" in out["error"]
    rc = main(["train-detector", "--synthetic", "--n-samples", "6",
               "--image-size", "64", "--epochs", "1", "--batch-size", "3",
               "--mesh", "2x1", "--device", "cpu", "--checkpoint-dir",
               str(tmp_path / "bad")])
    res = _last_json(capsys.readouterr().out)
    assert rc == 1 and res["status"] == "failed"
    assert "rank" in res["error"] and "divisible" in res["error"]
    # a 2-entry mesh with no process group to train in
    ds = TextDetectionDataset(np.zeros((2, 64, 64, 3), np.float32), {
        "probability_map": np.zeros((2, 64, 64), np.float32),
        "threshold_map": np.zeros((2, 64, 64), np.float32)})
    out = ModelTrainer({"checkpoint_dir": str(tmp_path / "x"),
                        "batch_size": 2},
                       mesh=make_mesh(n_data=2, device="cpu"),
                       device="cpu").train(DBNet(dtype=torch.float32), ds, ds)
    assert out["status"] == "failed" and "one process" in out["error"]
