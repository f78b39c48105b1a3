"""The port's DBNet training (``vtd_tpu_torch.train``) against
``vtd_tpu.train`` on the same numpy-seeded inputs and the same weights
(flax's init carried across by ``convert.dbnet_from_jax``), float32 on
both sides.

Tolerances: losses within 1e-6 absolute; label maps exactly equal;
BatchNorm running statistics within 1e-6. A train step: loss and aux
within rtol 1e-5; each gradient tensor with |g_port - g_ref| <= 1e-4
|g_ref| + 1e-7 and new running statistics within 1e-5, held on the DB
head's step and on the backbone's train mode block by block; on the
whole DBNet the same bounds plus 10x the float32 rounding the port's own
step carries there (its float32 against its float64 step), which is 1-7%
of a tensor at flax's init (the gap to the reference measured up to 3.7x
it; see ``test_dbnet_train_step_matches_reference``). Three AdamW steps: see ``test_three_steps_match_reference_
params``.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

H = W = 64
LR = 1e-4


def _nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# losses and labels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_reference(weighted):
    import jax.numpy as jnp

    from vtd_tpu.train import losses as ref
    from vtd_tpu_torch.train import losses as port

    rng = np.random.default_rng(0)
    pred = rng.random((3, 8, 8)).astype(np.float32)
    # probabilities at and within EPS of 0 and 1: the clip before the log
    # decides these (a clamp of the log at -100 would not)
    pred[0, 0, :4] = [0.0, 1.0, 1e-9, 1.0 - 1e-9]
    tgt = (rng.random((3, 8, 8)) < 0.4).astype(np.float32)
    thresh = rng.random((3, 1, 8, 8)).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)

    for name in ("bce_loss", "dice_loss"):
        want = float(getattr(ref, name)(jnp.asarray(pred), jnp.asarray(tgt),
                                        sample_weight=jw))
        got = float(getattr(port, name)(torch.from_numpy(pred),
                                        torch.from_numpy(tgt),
                                        sample_weight=tw))
        assert abs(got - want) <= 1e-6, (name, got, want)

    # maps with a channel axis: NHW1 in the reference, [B,1,H,W] here
    outs = {"probability": pred[:, None], "threshold": thresh}
    tgts = {"probability_map": tgt, "threshold_map": tgt[::-1].copy()}
    want_total, want_aux = ref.db_loss(
        {k: jnp.asarray(v).transpose(0, 2, 3, 1) for k, v in outs.items()},
        {k: jnp.asarray(v) for k, v in tgts.items()}, sample_weight=jw)
    got_total, got_aux = port.db_loss(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        {k: torch.from_numpy(v) for k, v in tgts.items()}, sample_weight=tw)
    assert set(got_aux) == set(want_aux)
    for k in want_aux:
        assert abs(float(got_aux[k]) - float(want_aux[k])) <= 1e-6, k
    assert abs(float(got_total) - float(want_total)) <= 1e-6


def _random_boxes(rng, shape, integer):
    x1 = rng.uniform(-8, W, shape)
    y1 = rng.uniform(-8, H, shape)
    b = np.stack([x1, y1, x1 + rng.uniform(0, 40, shape),
                  y1 + rng.uniform(0, 24, shape)], -1)
    return (np.round(b) if integer else b).astype(np.float32)


@pytest.mark.parametrize("integer", [True, False])
def test_label_maps_equal_reference(integer):
    import jax.numpy as jnp

    from vtd_tpu.train.labels import make_maps as ref_maps
    from vtd_tpu.train.labels import make_maps_batch as ref_batch
    from vtd_tpu_torch.train.labels import make_maps, make_maps_batch

    rng = np.random.default_rng(1 if integer else 2)
    boxes = _random_boxes(rng, (6, 8), integer)
    valid = rng.random((6, 8)) < 0.6  # invalid boxes must not paint
    valid[0] = False
    for i in range(len(boxes)):
        want = ref_maps(jnp.asarray(boxes[i]), jnp.asarray(valid[i]), H, W)
        got = make_maps(torch.from_numpy(boxes[i]),
                        torch.from_numpy(valid[i]), H, W)
        for g, w_ in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    want = ref_batch(jnp.asarray(boxes), jnp.asarray(valid), H, W)
    got = make_maps_batch(torch.from_numpy(boxes), torch.from_numpy(valid),
                          H, W)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert float(got[0][0].sum()) == 0.0


def test_dbnet_binary_map_matches_reference():
    import jax.numpy as jnp

    from vtd_tpu.models.dbnet import DBNet as RefDBNet
    from vtd_tpu_torch.models.dbnet import DBNet

    rng = np.random.default_rng(9)
    p = rng.random((2, 1, 8, 8)).astype(np.float32)
    t = rng.random((2, 1, 8, 8)).astype(np.float32)
    want = RefDBNet(dtype=jnp.float32).binary(
        {"probability": jnp.asarray(p), "threshold": jnp.asarray(t)})
    got = DBNet().binary({"probability": torch.from_numpy(p),
                          "threshold": torch.from_numpy(t)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_batchnorm_running_stats_match_flax():
    import flax.linen as nn
    import jax.numpy as jnp

    from vtd_tpu_torch.models.resnet import BatchNorm2d

    rng = np.random.default_rng(3)
    # 2 x 3 x 4 = 24 samples a channel: torch's unbiased running variance
    # would be 24/23 of flax's
    x = (rng.normal(size=(2, 3, 4, 5)) * [1.0, 2.0, 0.5, 3.0, 1.5]
         + [0.0, 1.0, -2.0, 0.5, 4.0]).astype(np.float32)
    ref = nn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    variables = ref.init(__import__("jax").random.PRNGKey(0), jnp.asarray(x))
    stats = {"mean": np.asarray(variables["batch_stats"]["mean"]) + 0.3,
             "var": np.asarray(variables["batch_stats"]["var"]) + 0.2}
    want, mutated = ref.apply(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x), mutable=["batch_stats"])

    bn = BatchNorm2d(5, eps=1e-5)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    new = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)
    bn.eval()  # eval mode is torch's own, on the running statistics
    with torch.no_grad():
        ev = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(
        ev.permute(0, 2, 3, 1).numpy(),
        (x - bn.running_mean.numpy()) / np.sqrt(bn.running_var.numpy() + 1e-5),
        atol=1e-5)


# ---------------------------------------------------------------------------
# train steps against the reference
# ---------------------------------------------------------------------------
def _maps(rng, b):
    from vtd_tpu_torch.train.labels import make_maps_batch

    boxes = _random_boxes(rng, (b, 4), integer=True)
    p, t = make_maps_batch(torch.from_numpy(boxes), torch.ones(b, 4,
                                                               dtype=bool), H, W)
    return {"probability_map": p.numpy(), "threshold_map": t.numpy()}


@pytest.fixture(scope="module")
def ref_net():
    """The reference's DBNet train state (flax init, AdamW), a batch of two
    frames with their label maps, and its loss, aux, gradients and new
    batch statistics on that batch (value_and_grad over its own apply and
    db_loss)."""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.dbnet import DBNet as RefDBNet
    from vtd_tpu.train.losses import db_loss
    from vtd_tpu.train.trainer import create_train_state

    model = RefDBNet(dtype=jnp.float32)
    state = create_train_state(model, jax.random.PRNGKey(0), (2, H, W, 3),
                               learning_rate=LR, weight_decay=1e-5)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    targets = _maps(rng, 2)
    params = jax.device_get(state["params"])
    stats = jax.device_get(state["batch_stats"])

    def loss_fn(prm):
        out, mutated = model.apply(
            {"params": prm, "batch_stats": stats}, jnp.asarray(images),
            train=True, mutable=["batch_stats"])
        total, aux = db_loss({k: v[..., 0] for k, v in out.items()},
                             {k: jnp.asarray(v) for k, v in targets.items()})
        return total, (aux, mutated["batch_stats"])

    (loss, (aux, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {
        "images": images, "targets": targets, "params": params,
        "stats": stats, "loss": float(loss), "aux": jax.device_get(aux),
        "grads": jax.device_get(grads), "new_stats": jax.device_get(new_stats),
    }


def _to_port(ref, params=None, stats=None):
    """A port state dict from the reference's trees; ``params`` / ``stats``
    replace sub-trees (by top-level name) of the whole DBNet's."""
    from vtd_tpu_torch.convert import dbnet_from_jax

    return dbnet_from_jax({"params": {**ref["params"], **(params or {})},
                           "batch_stats": {**ref["stats"], **(stats or {})}})


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _port_step(weights, images, targets, dtype=torch.float32, model=None):
    """One port make_train_step from ``weights`` (lr 0: the gradients and
    statistics of the step, parameters unmoved)."""
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.train.trainer import create_train_state, make_train_step

    st = create_train_state(model or DBNet(), learning_rate=0.0,
                            weights=weights, device="cpu")
    net = st["model"].to(dtype)
    aux = make_train_step(net, st["optimizer"])(
        _nhwc(images).to(dtype), {k: _nhwc(v).to(dtype)
                                  for k, v in targets.items()})
    return net, aux


def _stats_of(net):
    return {n: b.detach().double().numpy() for n, b in net.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def test_dbnet_train_step_matches_reference(ref_net):
    """The whole DBNet: loss and aux within rtol 1e-5. Its gradients and
    new statistics at flax's init carry float32 rounding of 1-7% a tensor
    (the port's float32 step against its float64 step on the same
    weights): train-mode BatchNorm over 8-32 samples a channel at C4/C5
    amplifies each layer's rounding, and ReLU masks flip with it. So each
    tensor is held to the stated bound plus 10x that measured float32 gap;
    the stated bounds alone are held block by block below."""
    ref = ref_net
    net, aux = _port_step(_to_port(ref), ref["images"], ref["targets"])
    assert set(aux) == set(ref["aux"])
    for k, v in ref["aux"].items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(aux["loss"]), ref["loss"], rtol=1e-5)
    net64, _ = _port_step(_to_port(ref), ref["images"], ref["targets"],
                          dtype=torch.float64)

    want = _to_port({"params": ref["grads"], "stats": ref["new_stats"]})
    g64 = dict(net64.named_parameters())
    assert len(g64) == len(_param_keys(want))
    for name, p in net.named_parameters():
        g, w = p.grad.double().numpy(), want[name].numpy()
        noise = np.linalg.norm(g - g64[name].grad.numpy())
        err = np.linalg.norm(g - w)
        assert err <= 1e-4 * np.linalg.norm(w) + 1e-7 + 10 * noise, (
            name, err, noise)
    s32, s64 = _stats_of(net), _stats_of(net64)
    for name, s in s32.items():
        w = want[name].numpy()
        err = np.linalg.norm(s - w)
        assert err <= 1e-5 * (np.linalg.norm(w) + np.sqrt(w.size)) + 10 * (
            np.linalg.norm(s - s64[name])), name


def _param_keys(sd):
    return [k for k in sd if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]


def _assert_grads(named_params, want):
    n = 0
    for name, p in named_params:
        g, w = p.grad.numpy(), want[name].numpy()
        err = np.linalg.norm(g - w)
        assert err <= 1e-4 * np.linalg.norm(w) + 1e-7, (name, err)
        n += 1
    assert n == len(_param_keys(want))


def _assert_stats(named_buffers, want):
    for name, buf in named_buffers:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def ref_head():
    """The reference's DB head (flax init) as a model of its own, with a
    batch of stride-4 features [2, 16, 16, 256] and 64x64 label maps."""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.dbnet import DBHead

    model = DBHead(dtype=jnp.float32)
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(2, H // 4, W // 4, 256)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(feats[:1]))
    return {"model": model, "feats": feats, "targets": _maps(rng, 2),
            "params": jax.device_get(variables["params"]),
            "stats": jax.device_get(variables["batch_stats"])}


def test_head_train_step_gradients_match_reference(ref_net, ref_head):
    """One make_train_step on the DB head alone (2 train-mode BatchNorms a
    branch): loss within rtol 1e-5, every gradient within 1e-4 |g| +
    1e-7, new statistics within 1e-5."""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.train.losses import db_loss
    from vtd_tpu_torch.models.dbnet import DBHead

    h = ref_head

    def loss_fn(prm):
        out, mutated = h["model"].apply(
            {"params": prm, "batch_stats": h["stats"]},
            jnp.asarray(h["feats"]), train=True, mutable=["batch_stats"])
        total, _ = db_loss({k: v[..., 0] for k, v in out.items()},
                           {k: jnp.asarray(v) for k, v in h["targets"].items()})
        return total, mutated["batch_stats"]

    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        h["params"])
    weights = _sub(_to_port(ref_net, {"head": h["params"]},
                            {"head": h["stats"]}), "head.")
    net, aux = _port_step(weights, h["feats"], h["targets"], model=DBHead())
    np.testing.assert_allclose(float(aux["loss"]), float(loss), rtol=1e-5)
    want = _sub(_to_port(ref_net, {"head": jax.device_get(grads)},
                         {"head": jax.device_get(new_stats)}), "head.")
    _assert_grads(net.named_parameters(), want)
    _assert_stats(net.named_buffers(), want)


def test_backbone_train_mode_gradients_match_reference(ref_net):
    """The backbone's train mode (the stem, max pool, bottlenecks with and
    without projection, train-mode BatchNorm) on a ResNet of one block a
    stage, both packages' ``ResNet50(stage_sizes=(1, 1, 1, 1))``: every
    gradient of sum(tap * R) over the four taps within 1e-4 |g| + 1e-7,
    new statistics within 1e-5."""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.resnet import ResNet50 as RefResNet
    from vtd_tpu_torch.models.resnet import ResNet50

    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    model = RefResNet(stage_sizes=(1, 1, 1, 1), dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(2), jnp.asarray(x[:1]))
    shapes = [t.shape for t in model.apply(variables, jnp.asarray(x))]
    rs = [rng.normal(size=s).astype(np.float32) for s in shapes]

    def loss_fn(prm):
        taps, mutated = model.apply(
            {"params": prm, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return sum(jnp.sum(t * r) for t, r in zip(taps, rs)), (mutated, taps)

    (loss, (mutated, ref_taps)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    weights = _sub(_to_port(ref_net, {"backbone": variables["params"]},
                            {"backbone": variables["batch_stats"]}),
                   "backbone.")
    net = ResNet50(stage_sizes=(1, 1, 1, 1))
    net.load_state_dict(weights)
    net.train()
    taps = net(_nhwc(x).permute(0, 3, 1, 2))
    got = sum((t * _nhwc(r).permute(0, 3, 1, 2)).sum()
              for t, r in zip(taps, rs))
    got.backward()
    # the loss sums terms of both signs: held to 1e-5 of the terms' size
    scale = sum(float(np.abs(np.asarray(t) * r).sum())
                for t, r in zip(ref_taps, rs))
    assert abs(float(got.detach()) - float(loss)) <= 1e-5 * scale
    want = _sub(_to_port(ref_net, {"backbone": jax.device_get(grads)},
                         {"backbone": jax.device_get(
                             mutated["batch_stats"])}), "backbone.")
    _assert_grads(net.named_parameters(), want)
    _assert_stats(net.named_buffers(), want)


def test_three_steps_match_reference_params(ref_net, ref_head):
    """Three make_train_step updates of both packages (AdamW at the
    detector's lr 1e-4, weight decay 1e-5) on the DB head as the model:
    per-step loss within rtol 1e-5, statistics within 1e-5, parameters
    within lr * 1e-3 (plus 2 float32 ulps of the parameter) where every
    step's reference gradient is above 1e-5, and within 2 * lr elsewhere.

    Why not the whole DBNet, and why 1e-5: AdamW's first update is
    sign(g) * lr, so an element whose float32 gradient is within rounding
    of 0 moves 2 * lr apart, and the next forward then differs. The whole
    DBNet's gradients carry 1-7% of such noise at flax's init (above), so
    its parameters part everywhere after 3 steps, as the port's float32
    run parts from its own float64 run. On the head the gradients carry
    ~1e-8 an element, which makes Adam's update of an element with
    |g| ~ 1e-6 uncertain at the 1e-2 * lr level."""
    import jax
    import jax.numpy as jnp
    import optax

    from vtd_tpu.train.losses import db_loss
    from vtd_tpu.train.trainer import make_train_step as ref_make_step
    from vtd_tpu_torch.models.dbnet import DBHead
    from vtd_tpu_torch.train.trainer import create_train_state, make_train_step

    h = ref_head
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=LR,
                                               weight_decay=1e-5)
    params = jax.tree_util.tree_map(jnp.array, h["params"])
    stats = jax.tree_util.tree_map(jnp.array, h["stats"])
    opt_state = tx.init(params)
    step = ref_make_step(h["model"], tx)
    feats = jnp.asarray(h["feats"])
    targets = {k: jnp.asarray(v) for k, v in h["targets"].items()}
    def grad_at(prm, st):
        out = h["model"].apply({"params": prm, "batch_stats": st}, feats,
                               train=True, mutable=["batch_stats"])[0]
        return db_loss({k: v[..., 0] for k, v in out.items()}, targets)[0]

    ref_losses, grads = [], []
    for _ in range(3):
        grads.append(jax.device_get(jax.grad(grad_at)(params, stats)))
        params, stats, opt_state, aux = step(params, stats, opt_state, feats,
                                             targets)
        ref_losses.append(float(aux["loss"]))

    weights = _sub(_to_port(ref_net, {"head": h["params"]},
                            {"head": h["stats"]}), "head.")
    st = create_train_state(DBHead(), learning_rate=LR, weight_decay=1e-5,
                            weights=weights, device="cpu")
    port_step = make_train_step(st["model"], st["optimizer"])
    batch = (_nhwc(h["feats"]), {k: _nhwc(v) for k, v in h["targets"].items()})
    losses = [float(port_step(*batch)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)

    want = _sub(_to_port(ref_net, {"head": jax.device_get(params)},
                         {"head": jax.device_get(stats)}), "head.")
    gs = [_sub(_to_port(ref_net, {"head": g}), "head.") for g in grads]
    for name, p in st["model"].named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        live = np.all([np.abs(g[name].numpy()) > 1e-5 for g in gs], axis=0)
        ulp = np.spacing(np.abs(want[name].numpy()))
        assert (d[live] <= (LR * 1e-3 + 2 * ulp)[live]).all(), (
            name, d[live].max())
        assert (d <= 2 * LR).all(), (name, d.max())
    _assert_stats(st["model"].named_buffers(), want)


# ---------------------------------------------------------------------------
# data, trainer, checkpoints
# ---------------------------------------------------------------------------
def test_synthetic_detection_data_equals_reference():
    from vtd_tpu.train.train_detector import (
        synthesize_detection_data as ref_synth,
    )
    from vtd_tpu_torch.train.train_detector import synthesize_detection_data

    want_img, want_t = ref_synth(6, size=96, seed=5)
    got_img, got_t = synthesize_detection_data(6, size=96, seed=5)
    np.testing.assert_array_equal(got_img, want_img)
    assert set(got_t) == set(want_t)
    for k in want_t:
        np.testing.assert_array_equal(got_t[k], want_t[k])
        assert got_t[k].sum() > 0


def test_dataset_batches_equal_reference():
    from vtd_tpu.train.trainer import TextDetectionDataset as RefDS
    from vtd_tpu_torch.train.trainer import TextDetectionDataset

    rng = np.random.default_rng(6)
    images = rng.random((5, 4, 4, 3)).astype(np.float32)
    targets = {"probability_map": rng.random((5, 4, 4)).astype(np.float32),
               "threshold_map": rng.random((5, 4, 4)).astype(np.float32)}
    for kw in ({"shuffle": True, "seed": 3}, {"with_valid": True}):
        want = list(RefDS(images, targets).batches(8, **kw))
        got = list(TextDetectionDataset(images, targets).batches(8, **kw))
        assert len(got) == len(want) == 1
        for g, w in zip(got[0], want[0]):
            if isinstance(w, dict):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            else:
                np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def tiny_dataset():
    from vtd_tpu_torch.train.labels import make_maps

    rng = np.random.default_rng(0)
    n = 8
    images = rng.random((n, H, W, 3), np.float32)
    p, t = make_maps(torch.tensor([[8.0, 8.0, 40.0, 24.0]]),
                     torch.tensor([True]), H, W)
    targets = {"probability_map": np.stack([p.numpy()] * n),
               "threshold_map": np.stack([t.numpy()] * n)}
    return images, targets


def test_model_trainer_end_to_end(tmp_path, tiny_dataset):
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.runtime.detector import TextDetector
    from vtd_tpu_torch.train.checkpoint import load_state_dict
    from vtd_tpu_torch.train.trainer import ModelTrainer, TextDetectionDataset

    images, targets = tiny_dataset
    ds = TextDetectionDataset(images, targets)
    trainer = ModelTrainer(
        {
            "checkpoint_dir": str(tmp_path / "ckpt"),
            "max_epochs": 2,
            "learning_rate": 1e-3,
            "weight_decay": 1e-5,
            "batch_size": 4,
        },
        device="cpu",
    )
    model = DBNet(dtype=torch.float32)
    result = trainer.train(model, ds, ds)
    assert result["status"] == "success", result
    assert result["epochs_trained"] == 2
    assert result["best_model_path"].endswith(".pt")
    assert np.isfinite(result["best_val_loss"])
    h = result["history"]
    assert h[-1]["train_loss"] <= h[0]["train_loss"] + 0.5
    for key in ("val_precision", "val_recall", "val_f1"):
        assert 0.0 <= h[-1][key] <= 1.0

    # the checkpoint restores, evaluates, and loads into the detector
    variables = load_state_dict(result["best_model_path"])
    assert "backbone.conv1.weight" in variables
    metrics = trainer.evaluate(DBNet(dtype=torch.float32), ds,
                               variables=variables)
    assert "val_loss" in metrics and np.isfinite(metrics["val_loss"])
    det = TextDetector(model_path=result["best_model_path"], input_size=H,
                       device="cpu")
    frames = torch.from_numpy((images[:2] * 255).astype(np.uint8))
    with torch.no_grad():
        prob = det.probability(frames)
    assert prob.shape == (2, H, W) and torch.isfinite(prob).all()


def test_model_trainer_failure_path_and_mesh(tmp_path):
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.train.trainer import ModelTrainer, TextDetectionDataset

    bad = TextDetectionDataset(
        np.zeros((2, 61, 61, 3), np.float32),  # maps come out 64x64
        {
            "probability_map": np.zeros((2, 61, 61), np.float32),
            "threshold_map": np.zeros((2, 61, 61), np.float32),
        },
    )
    trainer = ModelTrainer(
        {"checkpoint_dir": str(tmp_path), "max_epochs": 1, "batch_size": 2},
        device="cpu",
    )
    result = trainer.train(DBNet(dtype=torch.float32), bad, bad)
    assert result["status"] == "failed"
    assert "error" in result
    # a mesh: the data axis trains (tests/test_torch_train_mesh.py), and
    # so does the model axis (tests/test_torch_tp.py); a failed run on a
    # split model reports its error the same way
    from vtd_tpu_torch.core.mesh import make_mesh

    tp = ModelTrainer({"checkpoint_dir": str(tmp_path / "tp"),
                       "max_epochs": 1, "batch_size": 2},
                      mesh=make_mesh(n_data=1, n_model=2, device="cpu"),
                      device="cpu")
    failed = tp.train(DBNet(dtype=torch.float32), bad, bad)
    assert failed["status"] == "failed" and failed["error"]
    one = ModelTrainer({"checkpoint_dir": str(tmp_path / "m"),
                        "max_epochs": 1, "batch_size": 2},
                       mesh=make_mesh(n_data=1, device="cpu"), device="cpu")
    assert one.train(DBNet(dtype=torch.float32), bad, bad)["status"] == \
        "failed"


def test_top_k_checkpoints_drop_stale_ones(tmp_path, tiny_dataset):
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.train.trainer import ModelTrainer, TextDetectionDataset

    images, targets = tiny_dataset
    ds = TextDetectionDataset(images[:4], {k: v[:4] for k, v in
                                           targets.items()})
    trainer = ModelTrainer(
        {"checkpoint_dir": str(tmp_path), "max_epochs": 3, "batch_size": 4,
         "learning_rate": 1e-3, "save_top_k": 1},
        device="cpu",
    )
    result = trainer.train(DBNet(dtype=torch.float32), ds, ds)
    assert result["status"] == "success", result
    left = sorted(p.name for p in tmp_path.glob("*.pt"))
    assert len(left) == 1
    assert result["best_model_path"].endswith(left[0])
