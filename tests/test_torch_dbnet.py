"""The port's DBNet against the committed goldens and against
``vtd_tpu.models.dbnet.DBNet`` on weights carried across by
``vtd_tpu_torch.convert``, float32 on both sides.

Tolerances: the goldens' atol 2e-3 / rtol 1e-3 (those of
tests/test_import_goldens.py); probability maps of the whole net within
2e-4 (float32 convolution sums in another order).
"""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _load(name):
    z = np.load(os.path.join(GOLDENS, name))
    sd = {
        k[len("sd:"):]: torch.from_numpy(np.asarray(z[k]).astype(
            np.float32 if z[k].dtype == np.float16 else z[k].dtype
        ))
        for k in z.files if k.startswith("sd:")
    }
    rest = {k: np.asarray(z[k]) for k in z.files if not k.startswith("sd:")}
    return sd, rest


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_bottleneck_golden():
    from vtd_tpu_torch.models.resnet import Bottleneck

    sd, g = _load("bottleneck_golden.npz")
    block = Bottleneck(64, 64, stride=2).eval()
    block.load_state_dict(
        {k[len("layer1.0."):]: v for k, v in sd.items()}
    )
    with torch.no_grad():
        ours = block(_nchw(g["x"])).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, g["ref"], atol=2e-3, rtol=1e-3)


def test_dbhead_golden():
    from vtd_tpu_torch.convert import upsample_from_conv_transpose
    from vtd_tpu_torch.models.dbnet import _HeadBranch

    sd, g = _load("dbhead_golden.npz")
    branch = _HeadBranch(256).eval()
    state = {"conv.weight": sd["h.0.weight"]}
    for ours, ref in (("bn1", "h.1"), ("bn2", "h.4")):
        for stat in ("weight", "bias", "running_mean", "running_var",
                     "num_batches_tracked"):
            state[f"{ours}.{stat}"] = sd[f"{ref}.{stat}"]
    state.update(upsample_from_conv_transpose(
        sd["h.3.weight"].numpy(), sd["h.3.bias"].numpy(), "up1"))
    state.update(upsample_from_conv_transpose(
        sd["h.6.weight"].numpy(), sd["h.6.bias"].numpy(), "up2"))
    branch.load_state_dict(state)
    with torch.no_grad():
        ours = branch(_nchw(g["x"])).permute(0, 2, 3, 1).numpy()
    assert ours.shape == g["ref"].shape == (1, 32, 32, 1)
    np.testing.assert_allclose(ours, g["ref"], atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def jax_dbnet():
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.dbnet import DBNet as RefDBNet

    model = RefDBNet(dtype=jnp.float32)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)
    )
    # BatchNorm statistics away from identity, so the conversion of
    # every running mean/var is exercised
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.random(a.shape).astype(np.float32),
        jax.device_get(variables["batch_stats"]),
    )
    return model, {"params": jax.device_get(variables["params"]),
                   "batch_stats": stats}


def test_dbnet_converted_weights_match_reference(jax_dbnet):
    import jax
    import jax.numpy as jnp

    from vtd_tpu_torch.convert import dbnet_from_jax
    from vtd_tpu_torch.models.dbnet import DBNet

    model, variables = jax_dbnet
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))

    net = DBNet().eval()
    net.load_state_dict(dbnet_from_jax(variables))
    with torch.no_grad():
        got = net(_nchw(x))
        prob_only = net.probability(_nchw(x))
    for key in ("probability", "threshold"):
        np.testing.assert_allclose(
            got[key].permute(0, 2, 3, 1).numpy(), np.asarray(want[key]),
            atol=2e-4, err_msg=key,
        )
    assert torch.equal(prob_only, got["probability"][:, 0])
