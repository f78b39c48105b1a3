"""Checkpoints through the port's ``load_model`` / ``save_model`` against
the reference's loaders.

A DBNet ``.pth`` in the original app's layout (``tests/torch_app_layout.py``,
seeded, full ResNet50 widths, written with ``torch.save``) loads into
``TextDetector`` on the CPU. Its backbone and head equal what
``vtd_tpu.models.import_torch.import_dbnet_pth`` reads from the same
file, carried across by ``convert.dbnet_from_jax``; the FPN is the
recorded difference (each side fills it from its own init). With the
reference's FPN put in, the float32 forward is within the DBNet parity
tolerance of ``tests/test_torch_dbnet.py`` (atol 2e-4).

Then every format ``load_model`` takes, for the detector and the CRNN:
the port's torch file under a name with no torch suffix (what
``save_model`` writes), an orbax directory, a ``variables.pkl``
directory, a pickle file and the app's ``.pth``; each equal, tensor for
tensor, to the reference's loader on the same file.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from torch_app_layout import write_app_dbnet

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {"detector": os.path.join(ROOT, "models", "text_detector"),
               "crnn": os.path.join(ROOT, "models", "text_recognizer")}


@pytest.fixture(scope="module")
def app_pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("app") / "dbnet_app.pth")
    write_app_dbnet(path, seed=0)
    return path


@pytest.fixture(scope="module")
def reference_import(app_pth):
    from vtd_tpu.models.import_torch import import_dbnet_pth

    return import_dbnet_pth(app_pth)


def _equal_keys(a, b):
    return {k for k in a if torch.equal(a[k], b[k])}


def test_app_layout_matches_the_reference_import(app_pth, reference_import):
    from vtd_tpu_torch.convert import dbnet_from_jax
    from vtd_tpu_torch.runtime.detector import TextDetector

    det = TextDetector(model_path=app_pth, device="cpu")
    ours = det.model.state_dict()
    carried = dbnet_from_jax(reference_import)
    assert set(ours) == set(carried)
    # flax keeps no count of BatchNorm updates; the app's file does
    compared = {k for k in ours if not k.endswith("num_batches_tracked")}
    differ = compared - _equal_keys(ours, carried)
    assert differ == {k for k in compared if k.startswith("fpn.")}
    assert differ  # the FPN: each side's own init


def test_app_layout_forward_matches_the_reference(app_pth, reference_import):
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.dbnet import DBNet as RefDBNet
    from vtd_tpu_torch.convert import dbnet_from_jax
    from vtd_tpu_torch.runtime.detector import TextDetector

    det = TextDetector(model_path=app_pth, device="cpu")
    carried = dbnet_from_jax(reference_import)
    det.model.load_state_dict(
        {k: v for k, v in carried.items() if k.startswith("fpn.")},
        strict=False)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(RefDBNet(dtype=jnp.float32).apply)(
        reference_import, jnp.asarray(x))
    with torch.no_grad():
        got = det.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in ("probability", "threshold"):
        np.testing.assert_allclose(
            got[key].permute(0, 2, 3, 1).numpy(), np.asarray(want[key]),
            atol=2e-4, err_msg=key)


def _port(kind, path):
    if kind == "detector":
        from vtd_tpu_torch.runtime.detector import TextDetector

        return TextDetector(model_path=path, device="cpu")
    from vtd_tpu_torch.runtime.recognizer import TextRecognizer

    return TextRecognizer(model_path=path, use_transformer=False,
                          device="cpu")


def _module(kind, port):
    return port.model if kind == "detector" else port.crnn


def _reference_load(kind, path):
    """The reference's ``load_model`` (it reads nothing of ``self``),
    carried across by the port's converter."""
    import jax

    from vtd_tpu_torch.convert import crnn_from_jax, dbnet_from_jax

    if kind == "detector":
        from vtd_tpu.runtime.detector import TextDetector as Ref

        return dbnet_from_jax(jax.device_get(Ref.load_model(None, path)))
    from vtd_tpu.runtime.recognizer import TextRecognizer as Ref

    return crnn_from_jax(jax.device_get(Ref.load_model(None, path)))


def _write(kind, fmt, tmp_path):
    """A checkpoint of the repo's trained model in format ``fmt``."""
    from vtd_tpu_torch.train.checkpoint import restore_variables

    src = CHECKPOINTS[kind]
    if fmt == "orbax":
        return src
    if fmt == "pickle_dir":
        os.makedirs(tmp_path / "pkl")
        with open(tmp_path / "pkl" / "variables.pkl", "wb") as fh:
            pickle.dump(restore_variables(src), fh)
        return str(tmp_path / "pkl")
    if fmt == "pickle_file":
        with open(tmp_path / "weights.bin", "wb") as fh:
            pickle.dump(restore_variables(src), fh)
        return str(tmp_path / "weights.bin")
    assert fmt == "app_pth" and kind == "crnn"  # the app's keys are ours
    sd = _module(kind, _port(kind, src)).state_dict()
    torch.save({"model_state_dict": sd}, tmp_path / "crnn_app.pth")
    return str(tmp_path / "crnn_app.pth")


@pytest.mark.parametrize("kind,fmt", [
    ("detector", "orbax"), ("detector", "pickle_dir"),
    ("detector", "pickle_file"), ("crnn", "orbax"), ("crnn", "pickle_dir"),
    ("crnn", "pickle_file"), ("crnn", "app_pth"),
])
def test_load_model_matches_the_reference_loader(kind, fmt, tmp_path):
    path = _write(kind, fmt, tmp_path)
    port = _port(kind, path)
    got = port.load_model(path)
    want = _reference_load(kind, path)
    assert set(got) == set(want)
    assert all(v.device.type == "cpu" for v in got.values())
    compared = [k for k in got if not k.endswith("num_batches_tracked")]
    assert all(torch.equal(got[k], want[k]) for k in compared)
    state = _module(kind, port).state_dict()
    assert all(torch.equal(state[k], got[k]) for k in compared)


@pytest.mark.parametrize("kind", ["detector", "crnn"])
def test_save_model_round_trip_under_any_name(kind, tmp_path):
    """``save_model`` to a name with no torch suffix, then
    ``load_model`` and a new instance on the file: bit-equal."""
    from vtd_tpu_torch.train.checkpoint import is_torch_file, save_state_dict

    port = _port(kind, CHECKPOINTS[kind])
    module = _module(kind, port)
    path = str(tmp_path / "weights.bin")
    if kind == "detector":
        assert port.save_model(path) == path
    else:
        save_state_dict(path, module)
    assert is_torch_file(path) and not path.endswith((".pt", ".pth"))
    back = port.load_model(path)
    again = _module(kind, _port(kind, path)).state_dict()
    for k, v in module.state_dict().items():
        assert torch.equal(back[k], v) and torch.equal(again[k], v), k


@pytest.mark.parametrize("dropped", ["backbone.7.", "backbone.5.0.downsample.",
                                     "head.threshold_head.4."])
def test_a_partial_app_layout_raises(dropped, tmp_path):
    """A file that lacks part of the backbone (layer4, one downsample
    block) or of a head branch it holds does not load with seeded
    weights in the gap: the port raises KeyError at load. The reference
    raises too, at import (a missing key) or when the model is applied
    (a downsample it left out)."""
    import jax.numpy as jnp
    from flax.errors import ScopeParamNotFoundError

    from torch_app_layout import app_dbnet_state
    from vtd_tpu.models.dbnet import DBNet as RefDBNet
    from vtd_tpu.models.import_torch import import_dbnet_pth
    from vtd_tpu_torch.runtime.detector import TextDetector

    sd = {k: torch.from_numpy(v) for k, v in app_dbnet_state(0).items()
          if not k.startswith(dropped)}
    path = str(tmp_path / "partial.pth")
    torch.save({"model_state_dict": sd}, path)
    with pytest.raises(KeyError):
        TextDetector(model_path=path, device="cpu")
    with pytest.raises((KeyError, ScopeParamNotFoundError)):
        variables = import_dbnet_pth(path)
        RefDBNet(dtype=jnp.float32).apply(
            variables, jnp.zeros((1, 64, 64, 3), jnp.float32))
