"""The mesh's model axis in the port (``parallel/tensor_parallel.py``,
``parallel/sharding.py``) against ``vtd_tpu``'s on its 8 host devices
(tests/conftest.py), on the CPU at small sizes; the model-axis entries are
``cpu`` entries.

  (a) which tensors are split: the port's ``infer_param_shardings`` against
      the reference's, leaf for leaf through the converter's name map,
      with the split dimension (DBNet, CRNN, TrOCR at the default widths
      with one layer each), and the counts at full depth: 38 / 13 / 195
      split tensors, none in the trained TrOCR's config;
  (b) each split layer against the unsplit one on 2 and 4 entries, in
      float64: forward and gradients within 1e-12 of their scale (the
      same products, summed in the same order per output channel);
  (c) the CRNN pipeline on a 2x2 mesh (batch 8, 16 slots, 160x160, the
      demo checkpoints in float32) against the port's unsplit pipeline
      (equal transcripts and boxes, detection confidences within 1e-4,
      recognition within 1e-3) and against the reference's pipeline on a
      2x2 mesh (transcripts equal, boxes at IoU >= 0.95, detection
      confidences within the reference test's 5e-3);
  (d) a split TrOCR 256 wide against the unsplit one: tokens equal;
  (e) one DBNet train step on a 1x2 row (64x64, batch 4, flax's init)
      against the one-process step: loss rtol 1e-6; gradients within
      1e-12 of each tensor's norm in float64 and 1e-4 in float32 (the
      entries' input gradients are summed in another order; 1.3e-5
      measured, where train-mode BatchNorm over few samples amplifies the
      rounding, see tests/test_torch_train.py); and against the
      reference's float32 step on a (1, 2)
      mesh with its parameters placed by its ``infer_param_shardings``
      (loss and aux rtol 1e-5, every parameter within 2 * lr + 2 ulps as
      tests/test_torch_train_mesh.py holds the data-parallel step);
  (f) ``train-detector --mesh 2x2 --device cpu`` (two spawned gloo ranks,
      each splitting its model over its row of two entries; the
      reference's CLI test uses 4x2): its checkpoint loads into an
      unsplit ``TextDetector`` whose maps equal the split one's.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

import torch_mesh_tasks as tasks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_DIR = os.path.join(REPO, "demo_models2", "dbnet", "best_bf16")
REC_DIR = os.path.join(REPO, "demo_models2", "crnn", "crnn_final")
TROCR_CONFIG = os.path.join(REPO, "models",
                            "text_recognizer_trocr_config.json")
LR = 1e-4


# ---------------------------------------------------------------------------
# (a) the rule
# ---------------------------------------------------------------------------
def test_param_sharding_rules():
    """The counterpart of tests/test_parallel.py::test_param_sharding_rules,
    on the reference's layout (a Dense [in, out] is the port's Linear
    [out, in])."""
    from torch import nn

    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.parallel.sharding import (
        infer_param_shardings, param_spec,
    )

    mesh = make_mesh(n_data=4, n_model=2, device="cpu")
    assert mesh.row(1) == [torch.device("cpu")] * 2
    model = nn.ModuleDict({
        "wide": nn.Linear(512, 512, bias=False),
        "narrow": nn.Linear(16, 16, bias=False),
        "odd": nn.Linear(512, 511, bias=False),
    })
    model.register_buffer("scalar", torch.zeros(()))
    assert infer_param_shardings(model, mesh) == {
        "scalar": None, "wide.weight": 0, "narrow.weight": None,
        "odd.weight": None}
    assert param_spec((512, 512), 2) == 1
    assert param_spec((512, 511), 2) is None
    assert param_spec((16, 16), 2) is None
    assert param_spec((), 2) is None
    assert param_spec((512, 512), 1) is None  # no model axis
    # a 1-D tensor needs min_size**2 elements too; the minimum is a knob
    assert param_spec((512,), 2) is None
    assert param_spec((64, 64), 2, min_size=64) == 1


def _marked(shapes, shardings):
    """The reference's tree with each split leaf counting along its split
    (last) dimension and every other leaf 0."""
    import jax

    from vtd_tpu.core.mesh import MODEL_AXIS

    def mark(s, sh):
        if MODEL_AXIS not in tuple(sh.spec):
            return np.zeros(s.shape, np.float32)
        return np.broadcast_to(
            1.0 + np.arange(s.shape[-1], dtype=np.float32), s.shape)

    return jax.tree_util.tree_map(mark, shapes, shardings)


def _varying_dim(t: torch.Tensor):
    """The one dimension ``t`` varies along (None if it is constant)."""
    dims = [d for d in range(t.dim())
            if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(dims) <= 1
    return dims[0] if dims else None


def _ref_shapes(kind):
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    if kind == "dbnet":
        from vtd_tpu.models.dbnet import DBNet

        return jax.eval_shape(DBNet(dtype=jnp.float32).init, key,
                              jnp.zeros((1, 64, 64, 3)))
    if kind == "crnn":
        from vtd_tpu.models.crnn import CRNN

        return jax.eval_shape(CRNN(dtype=jnp.float32).init, key,
                              jnp.zeros((1, 32, 128, 3)))
    from vtd_tpu.models.trocr import TrOCR, TrOCRConfig

    cfg = kind
    return jax.eval_shape(TrOCR(cfg).init, key,
                          jnp.zeros((1, cfg.image_size, cfg.width, 3)),
                          jnp.zeros((1, 2), jnp.int32))


@pytest.mark.parametrize("kind", ["dbnet", "crnn", "trocr"])
def test_split_tensors_are_the_reference_s(kind):
    """Leaf for leaf: a tensor is split by the port exactly when the
    reference's ``infer_param_shardings`` splits it on a (4, 2) mesh, and
    along the dimension the converter carries the reference's last one
    to."""
    import jax

    from vtd_tpu.core.mesh import make_mesh as ref_make_mesh
    from vtd_tpu.models.trocr import TrOCRConfig as RefConfig
    from vtd_tpu.parallel.sharding import (
        infer_param_shardings as ref_infer,
    )
    from vtd_tpu_torch import convert
    from vtd_tpu_torch.models.crnn import CRNN
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.models.trocr import TrOCR, TrOCRConfig
    from vtd_tpu_torch.parallel.sharding import infer_param_shardings

    mesh = ref_make_mesh(n_data=4, n_model=2)
    if kind == "trocr":  # the default widths, one layer each
        ref_cfg = RefConfig(enc_layers=1, dec_layers=1)
        shapes = _ref_shapes(ref_cfg)
        cfg = TrOCRConfig(enc_layers=1, dec_layers=1)
        with torch.device("meta"):
            port = TrOCR(cfg)
        to_port = lambda v: convert.trocr_from_jax(v, cfg)  # noqa: E731
        want_n = 2 + 6 + 10 + 1  # patch and pos embeds, enc and dec blocks
    else:
        shapes = _ref_shapes(kind)
        with torch.device("meta"):
            port = DBNet() if kind == "dbnet" else CRNN()
        to_port = (convert.dbnet_from_jax if kind == "dbnet"
                   else convert.crnn_from_jax)
        want_n = 38 if kind == "dbnet" else 13
    marked = to_port(jax.tree_util.tree_map(
        np.asarray, _marked(shapes, ref_infer(shapes, mesh))))
    got = infer_param_shardings(port, 2)
    assert set(marked) <= set(got)
    assert all(k.endswith("num_batches_tracked")
               for k in set(got) - set(marked))
    for k, t in marked.items():
        assert _varying_dim(t.float()) == got[k], k
    assert sum(d is not None for d in got.values()) == want_n


def test_split_counts_at_full_depth():
    """38 / 13 / 195 split tensors as the reference counts them (shapes
    only), and none in the trained TrOCR's config (128 / 256 wide)."""
    import jax

    from vtd_tpu.core.mesh import MODEL_AXIS
    from vtd_tpu.core.mesh import make_mesh as ref_make_mesh
    from vtd_tpu.models.trocr import TrOCRConfig as RefConfig
    from vtd_tpu.train.trocr_trainer import load_config as ref_load_config
    from vtd_tpu.parallel.sharding import (
        infer_param_shardings as ref_infer,
    )
    from vtd_tpu_torch.models.crnn import CRNN
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.models.trocr import TrOCR, TrOCRConfig, load_config
    from vtd_tpu_torch.parallel.sharding import infer_param_shardings

    mesh = ref_make_mesh(n_data=4, n_model=2)

    def ref_count(shapes):
        return sum(MODEL_AXIS in tuple(s.spec) for s in
                   jax.tree_util.tree_leaves(ref_infer(shapes, mesh)))

    with torch.device("meta"):
        port = {"dbnet": DBNet(), "crnn": CRNN(),
                "default": TrOCR(TrOCRConfig()),
                "trained": TrOCR(load_config(TROCR_CONFIG))}
    ref = {"dbnet": _ref_shapes("dbnet"), "crnn": _ref_shapes("crnn"),
           "default": _ref_shapes(RefConfig()),
           "trained": _ref_shapes(ref_load_config(TROCR_CONFIG))}
    counts = {k: sum(d is not None for d in
                     infer_param_shardings(m, 2).values())
              for k, m in port.items()}
    assert counts == {k: ref_count(v) for k, v in ref.items()} == {
        "dbnet": 38, "crnn": 13, "default": 195, "trained": 0}


# ---------------------------------------------------------------------------
# (b) the split layers
# ---------------------------------------------------------------------------
def _layers():
    from torch import nn

    class Pos(nn.Module):  # a bare parameter the rule splits
        def __init__(self):
            super().__init__()
            self.pos = nn.Parameter(torch.zeros(1, 300, 256))

        def forward(self, x):
            return x + self.pos

    gen = torch.Generator().manual_seed(3)
    cases = {
        "conv": (nn.Conv2d(32, 256, 3, padding=1, stride=2),
                 torch.randn(2, 32, 12, 12, generator=gen)),
        "linear": (nn.Linear(256, 512), torch.randn(3, 5, 256, generator=gen)),
        "embedding": (nn.Embedding(300, 256),
                      torch.randint(0, 300, (4, 7), generator=gen)),
        "lstm": (nn.LSTM(256, 256, 2, bidirectional=True, batch_first=True),
                 torch.randn(2, 9, 256, generator=gen)),
        "parameter": (Pos(), torch.randn(2, 300, 256, generator=gen)),
    }
    for layer, _ in cases.values():
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return cases


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["conv", "linear", "embedding", "lstm",
                                  "parameter"])
def test_split_layer_matches_unsplit(kind, n):
    from torch import nn

    from vtd_tpu_torch.parallel import (
        ColumnParallel, GatheredLSTM, n_split, tensor_parallel_,
    )

    layer, x = _layers()[kind]
    layer = layer.double()
    if x.is_floating_point():
        x = x.double()
    root = nn.Sequential(layer)
    split = tensor_parallel_(copy.deepcopy(root), ["cpu"] * n)
    want_type = {"lstm": GatheredLSTM, "parameter": type(split[0])}.get(
        kind, ColumnParallel)
    assert isinstance(split[0], want_type)
    assert n_split(split) == (4 * 2 if kind == "lstm" else 1)
    # the state dict keeps the unsplit keys and full shapes, both ways
    sd, sd_split = root.state_dict(), split.state_dict()
    assert list(sd) == list(sd_split)
    assert all(torch.equal(sd[k], sd_split[k]) for k in sd)
    copy.deepcopy(root).load_state_dict(sd_split)
    tensor_parallel_(copy.deepcopy(root), ["cpu"] * n).load_state_dict(sd)

    def run(model, inp):
        if inp.is_floating_point():
            inp = inp.clone().requires_grad_(True)
        out = model(inp)
        out = out[0] if isinstance(out, tuple) else out
        weight = torch.linspace(-1, 1, out.numel(), dtype=out.dtype)
        (out * weight.view(out.shape)).sum().backward()
        gx = inp.grad if inp.is_floating_point() else None
        return out.detach(), gx, _full_grads(model)

    out0, gx0, g0 = run(root, x)
    out1, gx1, g1 = run(split, x)
    assert (out1 - out0).abs().max() <= 1e-12 * out0.abs().max()
    if gx0 is not None:
        assert (gx1 - gx0).abs().max() <= 1e-12 * gx0.abs().max()
    assert list(g1) == list(g0)
    for name, g in g0.items():
        assert (g1[name] - g).abs().max() <= 1e-12 * g.abs().max(), name


def _full_grads(model):
    """Every tensor's gradient at the unsplit model's name and full shape
    (a split tensor's shards' gradients gathered)."""
    from vtd_tpu_torch.parallel.tensor_parallel import _Sharded

    out = {}
    for qual, m in model.named_modules():
        pre = qual + "." if qual else ""
        if ".parametrizations" in pre or pre.startswith("parametrizations"):
            continue
        if isinstance(m, _Sharded):
            for name, dim in m._held.items():
                if dim is None:
                    if getattr(m, name) is not None:
                        out[pre + name] = getattr(m, name).grad
                else:
                    out[pre + name] = torch.cat(
                        [s.grad for s in m.shards(name)], dim)
            continue
        for name, p in m.named_parameters(recurse=False):
            out[pre + name] = p.grad
        for name, plist in getattr(m, "parametrizations", {}).items():
            shards = [p.grad for _, p in
                      sorted(plist.named_parameters(recurse=False))]
            out[pre + name] = torch.cat(shards, plist[0].dim)
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# (c) the split CRNN pipeline
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return tasks.converted_weights(tmp_path_factory.mktemp("w"), DET_DIR,
                                   REC_DIR)


def test_split_pipeline_matches_unsplit_and_reference(weights):
    import jax

    from vtd_tpu.core.mesh import make_mesh as ref_make_mesh
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.parallel import n_split
    from vtd_tpu_torch.runtime import VideoTextPipeline

    frames = tasks.text_frames()
    valid = np.ones(8, bool)
    one = VideoTextPipeline(*weights, batch_size=8, device="cpu",
                            **tasks.PIPE)
    want = one.process_batch(frames, valid)
    pipe = VideoTextPipeline(*weights, batch_size=8, **tasks.PIPE,
                             mesh=make_mesh(n_data=2, n_model=2,
                                            device="cpu"))
    try:
        assert len(pipe.replicas) == 2
        # something is split, as the reference's test demands of its mesh
        for rep in pipe.replicas:
            assert n_split(rep.detector.model) == 38
            assert n_split(rep.recognizer.crnn) == 13
        handles = pipe.dispatch_batch(frames, valid_frames=valid)
        assert len(handles["shards"]) == 2
        got = pipe.process_batch(frames, valid, handles=handles)
    finally:
        pipe.close()
    assert [d["text"] for f in got for d in f] == [
        f"TXT{i}" for i in range(8)]
    for g, w in zip(got, want):
        assert [d["text"] for d in g] == [d["text"] for d in w]
        for dg, dw in zip(g, w):
            assert dg["bbox"] == dw["bbox"]
            assert abs(dg["detection_confidence"]
                       - dw["detection_confidence"]) <= 1e-4
            assert abs(dg["recognition_confidence"]
                       - dw["recognition_confidence"]) <= 1e-3
    ref = tasks.reference_pipeline(
        DET_DIR, REC_DIR, batch_size=8,
        mesh=ref_make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4]),
        **tasks.PIPE)
    want_ref = ref.process_batch(frames, valid)
    assert tasks.assert_like_reference(got, want_ref) >= 8


# ---------------------------------------------------------------------------
# (d) a split TrOCR
# ---------------------------------------------------------------------------
def test_split_trocr_tokens_equal():
    from vtd_tpu_torch.models.trocr import small_config
    from vtd_tpu_torch.parallel import n_split
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer

    cfg = small_config(image_size=256, enc_dim=256, dec_dim=256, enc_mlp=512,
                       dec_mlp=512, enc_layers=1, dec_layers=2)
    rec = TransformerRecognizer(config=cfg, seed=1, device="cpu")
    split = rec.replica(["cpu", "cpu"])
    # q, k, v, o, fc1, fc2 of the encoder block, 10 of each decoder
    # block, the patch embedding and its position table (257 x 256); the
    # token table (98 x 256) is too small
    assert n_split(split.model) == 6 + 2 * 10 + 2
    crops = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 256, 256, 3)).astype(np.float32))
    toks0, conf0 = rec.generate(crops)
    toks1, conf1 = split.generate(crops)
    assert torch.equal(toks0, toks1)
    assert (conf0 - conf1).abs().max() <= 1e-5
    enc0, enc1 = rec.model.encode(crops), split.model.encode(crops)
    assert (enc0 - enc1).abs().max() <= 1e-5 * enc0.abs().max()


# ---------------------------------------------------------------------------
# (e) one split DBNet train step
# ---------------------------------------------------------------------------
def test_split_dbnet_step_matches_one_process_and_reference():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from vtd_tpu.core.mesh import make_mesh as ref_make_mesh
    from vtd_tpu.models.dbnet import DBNet as RefDBNet
    from vtd_tpu.parallel.sharding import (
        batch_sharding, infer_param_shardings,
    )
    from vtd_tpu.train.trainer import create_train_state as ref_state
    from vtd_tpu.train.trainer import make_train_step as ref_step
    from vtd_tpu_torch.convert import dbnet_from_jax
    from vtd_tpu_torch.models.dbnet import DBNet
    from vtd_tpu_torch.parallel import n_split
    from vtd_tpu_torch.train.trainer import create_train_state, make_train_step

    images, targets = tasks.dbnet_batch()
    state = ref_state(RefDBNet(dtype=jnp.float32), jax.random.PRNGKey(0),
                      images.shape, learning_rate=LR, weight_decay=1e-5)
    weights = dbnet_from_jax({
        "params": jax.device_get(state["params"]),
        "batch_stats": jax.device_get(state["batch_stats"])})

    def port_step(row, dtype):
        st = create_train_state(DBNet(), learning_rate=LR, weight_decay=1e-5,
                                weights=weights, device="cpu", row=row)
        model = st["model"].to(dtype)
        aux = make_train_step(model, st["optimizer"])(
            torch.from_numpy(images).to(dtype),
            {k: torch.from_numpy(v).to(dtype) for k, v in targets.items()})
        return model, {k: float(v) for k, v in aux.items()}

    for dtype, grad_tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        one, aux1 = port_step(None, dtype)
        split, aux2 = port_step(["cpu", "cpu"], dtype)
        assert n_split(split) == 38
        for k in aux1:
            assert aux2[k] == pytest.approx(aux1[k], rel=1e-6), k
        g1, g2 = _full_grads(one), _full_grads(split)
        assert list(g1) == list(g2)
        for k, g in g1.items():
            assert (g2[k] - g).norm() <= grad_tol * g.norm(), (dtype, k)
    sd1, sd2 = one.state_dict(), split.state_dict()  # float32
    assert list(sd1) == list(sd2)
    for k in sd1:  # after AdamW: within 2 * lr + 2 ulps
        tol = 2 * LR + 2 * np.finfo(np.float32).eps * sd1[k].float().abs()
        assert ((sd2[k].float() - sd1[k].float()).abs() <= tol).all(), k

    mesh = ref_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    pshard = infer_param_shardings(state["params"], mesh)
    params = jax.tree_util.tree_map(jax.device_put, state["params"], pshard)
    stats = jax.device_put(state["batch_stats"], NamedSharding(mesh, P()))
    new_params, new_stats, _, aux = ref_step(state["model"], state["tx"])(
        params, stats, state["opt_state"],
        jax.device_put(images, batch_sharding(mesh, 4)),
        {k: jax.device_put(v, batch_sharding(mesh, 3))
         for k, v in targets.items()})
    ref = dbnet_from_jax({"params": jax.device_get(new_params),
                          "batch_stats": jax.device_get(new_stats)})
    for k, v in aux.items():
        assert aux2[k] == pytest.approx(float(v), rel=1e-5), k
    for k, want in ref.items():
        if k.endswith("num_batches_tracked"):  # the port's counter alone
            continue
        tol = 2 * LR + 2 * np.finfo(np.float32).eps * want.abs()
        assert ((sd2[k].float() - want).abs() <= tol).all(), k


# ---------------------------------------------------------------------------
# (f) the command line
# ---------------------------------------------------------------------------
def test_cli_train_detector_mesh_2x2(tmp_path, capsys):
    from vtd_tpu_torch.__main__ import main
    from vtd_tpu_torch.runtime import TextDetector

    rc = main(["train-detector", "--synthetic", "--n-samples", "6",
               "--image-size", "64", "--epochs", "1", "--batch-size", "4",
               "--mesh", "2x2", "--device", "cpu", "--checkpoint-dir",
               str(tmp_path / "tp")])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["status"] == "success", res
    assert np.isfinite(res["best_val_loss"])
    det = TextDetector(model_path=res["best_model_path"], input_size=64,
                       device="cpu")
    split = det.replica(["cpu", "cpu"])
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    with torch.inference_mode():
        p0, p1 = det.probability(frames), split.probability(frames)
    assert p0.shape == (2, 64, 64) and bool(torch.isfinite(p0).all())
    assert (p1 - p0).abs().max() <= 1e-5
