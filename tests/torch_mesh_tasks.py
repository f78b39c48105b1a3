"""Targets of the ranks that the port's multi-device tests spawn
(``vtd_tpu_torch.core.mesh.spawn_ranks`` pickles them by import path), and
the inputs the tests share. Imports nothing of JAX: a spawned rank starts
from a fresh interpreter."""
import numpy as np
import torch
import torch.distributed as dist


def dbnet_batch(b: int = 4, size: int = 64, seed: int = 4):
    """Random images and the DB maps of random boxes (4 a frame)."""
    from vtd_tpu_torch.train.labels import make_maps_batch

    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, size, size, 3)).astype(np.float32)
    x1 = rng.uniform(-8, size, (b, 4))
    y1 = rng.uniform(-8, size, (b, 4))
    boxes = np.round(np.stack(
        [x1, y1, x1 + rng.uniform(0, 40, (b, 4)),
         y1 + rng.uniform(0, 24, (b, 4))], -1)).astype(np.float32)
    p, t = make_maps_batch(torch.from_numpy(boxes),
                           torch.ones(b, 4, dtype=torch.bool), size, size)
    return images, {"probability_map": p.numpy(), "threshold_map": t.numpy()}


def dbnet_step(weights, images, targets, dtype, group=None, lr=1e-4):
    """One ``make_train_step`` of a DBNet from ``weights`` (AdamW at
    ``lr``, weight decay 1e-5) -> (model after the step, aux floats)."""
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.train.trainer import create_train_state, make_train_step

    st = create_train_state(DBNet(), learning_rate=lr, weight_decay=1e-5,
                            weights=weights, device="cpu")
    net = st["model"].to(dtype)
    aux = make_train_step(net, st["optimizer"], group)(
        torch.from_numpy(images).to(dtype),
        {k: torch.from_numpy(v).to(dtype) for k, v in targets.items()})
    return net, {k: float(v) for k, v in aux.items()}


def step_result(net, aux) -> dict:
    return {
        "aux": aux,
        "state": {k: v.detach().clone() for k, v in net.state_dict().items()},
        "grads": {k: p.grad.detach().clone()
                  for k, p in net.named_parameters()},
    }


def dbnet_step_rank(rank: int, weights_path: str, out_path: str) -> dict:
    """This rank's slice of ``dbnet_batch()`` through one data-parallel
    step in float32 and in float64; rank 0 saves both results to
    ``out_path`` (``{dtype name: step_result}``); every rank returns its
    aux and a fingerprint of its parameters after the step."""
    from vtd_tpu_torch.core.mesh import local_batch_slice, make_mesh

    torch.set_num_threads(2)
    images, targets = dbnet_batch()
    world = dist.get_world_size()
    start, size = local_batch_slice(
        len(images), make_mesh(n_data=world, device="cpu"))
    rows = slice(start, start + size)
    saved, out = {}, {"rows": [start, size]}
    for dtype in (torch.float32, torch.float64):
        net, aux = dbnet_step(
            torch.load(weights_path), images[rows],
            {k: v[rows] for k, v in targets.items()}, dtype,
            dist.group.WORLD)
        name = str(dtype).split(".")[-1]
        saved[name] = step_result(net, aux)
        out[name] = {"aux": aux, "params": [
            p.detach().double().sum().item() for p in net.parameters()]}
    if rank == 0:
        torch.save(saved, out_path)
    return out


def global_stats_rank(rank: int, x: np.ndarray, w: np.ndarray) -> dict:
    """A float64 toy with a BatchNorm-style global statistic and a
    Dice-style global ratio: this rank's rows of ``x`` through
    ``all_reduce_sum``; returns the loss and the averaged gradient of
    ``w``."""
    from vtd_tpu_torch.parallel.collectives import (
        all_reduce_sum, average_gradients,
    )

    world = dist.get_world_size()
    rows = len(x) // world
    xs = torch.from_numpy(x[rank * rows:(rank + 1) * rows])
    param = torch.nn.Parameter(torch.from_numpy(w.copy()))
    loss = toy_loss(xs, param, lambda t: all_reduce_sum(t, dist.group.WORLD))
    loss.backward()
    before = param.grad.clone()
    average_gradients([param], dist.group.WORLD)
    return {"loss": float(loss), "grad": param.grad.numpy(),
            "own_grad": before.numpy()}


def toy_loss(x: torch.Tensor, w: torch.Tensor, reduce=lambda t: t):
    """Normalise ``x @ w`` with statistics over every row (``reduce``
    sums them over the ranks), then 1 - Dice of its sigmoid against a
    fixed target."""
    y = x @ w
    n = reduce(y.new_tensor([float(y.shape[0])]))
    mean = reduce(y.sum(0, keepdim=True)) / n
    var = reduce((y * y).sum(0, keepdim=True)) / n - mean * mean
    p = torch.sigmoid((y - mean) / torch.sqrt(var + 1e-5))
    t = (x[:, :1] > 0).to(x.dtype)
    inter, total = reduce(torch.stack([(p * t).sum(), p.sum() + t.sum()]))
    return 1 - 2 * inter / total


def failing_rank(rank: int) -> int:
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return rank


def echo_rank(rank: int, value: float) -> dict:
    """The group's shape, backend and an all-reduced value."""
    t = torch.tensor([value * (rank + 1)])
    dist.all_reduce(t)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "sum": float(t)}


# ---------------------------------------------------------------------------
# inference inputs shared by the data-parallel and two-stage tests
# ---------------------------------------------------------------------------
PIPE = dict(use_transformer_ocr=False, max_dets=16, detector_input_size=160)


def text_frames(b: int = 8, h: int = 240, w: int = 320, text=None):
    """Light frames with one dark word each (``TXT<i>`` by default)."""
    import cv2

    frames = np.full((b, h, w, 3), 235, np.uint8)
    for i in range(b):
        cv2.putText(frames[i], text or f"TXT{i}", (40, 120),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.5, (0, 0, 0), 3)
    return frames


def dense_frames(b: int = 8, n_dense: int = 2):
    """The first ``n_dense`` frames carry six words each, the others none:
    all of a batch's text in the first block of a 2-way split."""
    import cv2

    words = ["AB1", "CD2", "EF3", "GH4", "IJ5", "KL6"]
    frames = np.full((b, 240, 320, 3), 235, np.uint8)
    for i in range(n_dense):
        for r in range(3):
            for c in range(2):
                cv2.putText(frames[i], words[(2 * r + c + i) % 6],
                            (20 + 150 * c, 60 + 70 * r),
                            cv2.FONT_HERSHEY_SIMPLEX, 1.2, (0, 0, 0), 3)
    return frames


def converted_weights(out_dir, det_dir: str, rec_dir: str):
    """The port's .pt files of the reference's trained checkpoints."""
    import os

    from vtd_tpu_torch.convert import crnn_from_jax, dbnet_from_jax
    from vtd_tpu_torch.train.checkpoint import restore_variables

    det = os.path.join(str(out_dir), "dbnet.pt")
    rec = os.path.join(str(out_dir), "crnn.pt")
    torch.save(dbnet_from_jax(restore_variables(det_dir)), det)
    torch.save(crnn_from_jax(restore_variables(rec_dir)), rec)
    return det, rec


def reference_pipeline(det_dir: str, rec_dir: str, **kw):
    """``vtd_tpu``'s pipeline computing in float32 on float32 weights (the
    demo detector is stored in bf16; see tests/test_torch_pipeline.py),
    its variables placed on its mesh again after the cast and its program
    rebuilt; a two-stage pipeline gets a runner built on the float32
    models."""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.crnn import CRNN
    from vtd_tpu.models.dbnet import DBNet
    from vtd_tpu.runtime import VideoTextPipeline as RefPipeline

    pipe = RefPipeline(detector_path=det_dir, recognizer_path=rec_dir,
                       recognizer_kwargs={"pad_batch": 32}, **kw)
    pipe.detector.model = DBNet(dtype=jnp.float32)
    pipe.detector.variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(jax.device_get(a), jnp.float32),
        pipe.detector.variables)
    pipe.recognizer.crnn = CRNN(dtype=jnp.float32)
    if pipe.mesh is not None:
        pipe._apply_mesh(pipe.mesh)
    if pipe.parallel_mode == "two_stage":
        from vtd_tpu.parallel.pipeline import TwoStagePipeline

        pipe._detect_crop = TwoStagePipeline(
            pipe.detector, pipe.recognizer, max_dets=pipe.max_dets,
            crop_hw=pipe.crop_hw, max_box_frac=pipe.max_box_frac)
    else:
        pipe._detect_crop = pipe._build_detect_crop()
    return pipe


def iou(a, b) -> float:
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1)


def assert_like_reference(got, want, conf_tol: float = 5e-3) -> int:
    """Port results against the reference's: the same transcripts in the
    same order, boxes at IoU >= 0.95 (two frameworks' float32), detection
    confidences within ``conf_tol``. Returns the detections compared."""
    assert len(got) == len(want)
    n = 0
    for g, w in zip(got, want):
        assert [d["text"] for d in g] == [d["text"] for d in w]
        for dg, dw in zip(g, w):
            assert iou(dg["bbox"], dw["bbox"]) >= 0.95, (dg, dw)
            assert abs(dg["detection_confidence"]
                       - dw["detection_confidence"]) <= conf_tol
            n += 1
    return n
