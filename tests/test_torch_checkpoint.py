"""The port's checkpoint restore (``vtd_tpu_torch.train``) against
``vtd_tpu.train.checkpoint.restore_variables``, and the loaders built on
it against ``vtd_tpu``'s pipeline on the shipped verify frame.

Tolerances: restored trees bit-equal (bf16 after exact widening to
float32); the reader's zstd output byte-equal to ``zstandard``'s and its
arrays equal to what ``tensorstore`` reads. On the shipped frame
(``tests/torch_data/verify_frames.npz``, 640x640, detector input 640)
transcripts equal, boxes within 1 px, detection confidences within 1e-3
(float16 pack) and recognition confidences within 1e-3, float32 on both
sides (the reference's bf16 detector weights cast to float32).
"""
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = [
    "demo_models2/dbnet/best_bf16",
    "demo_models2/crnn/crnn_final",
    "demo_models2/trocr/trocr_final",
    "demo_models2/trocr_r4b/trocr_final",
    "demo_models2/trocr_r5/trocr_final",
    "models/text_detector",
    "models/text_recognizer",
    "models/text_recognizer_trocr",
]
VERIFY = os.path.join(REPO, "tests", "torch_data", "verify_frames.npz")


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def test_every_checkpoint_dir_is_listed():
    found = set()
    for top in ("demo_models2", "models"):
        for root, dirs, files in os.walk(os.path.join(REPO, top),
                                         followlinks=True):
            if "_METADATA" in files:
                found.add(os.path.relpath(root, REPO))
    assert found == set(CHECKPOINTS)


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
def test_restore_is_bit_equal_to_reference(ckpt):
    from vtd_tpu.train.checkpoint import restore_variables as ref_restore
    from vtd_tpu_torch.train.checkpoint import restore_variables

    want = dict(_flat(ref_restore(os.path.join(REPO, ckpt))))
    got = dict(_flat(restore_variables(os.path.join(REPO, ckpt))))
    assert list(got) == list(want)
    for key, w in want.items():
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)  # exact
        g = got[key]
        assert isinstance(g, np.ndarray), key
        assert (g.shape, g.dtype) == (w.shape, w.dtype), key
        assert g.tobytes() == w.tobytes(), key


def test_stored_dtypes_give_bf16_back():
    from vtd_tpu.train.checkpoint import restore_variables as ref_restore
    from vtd_tpu_torch.train.checkpoint import (
        restore_variables, stored_dtypes, to_torch,
    )

    path = os.path.join(REPO, "models", "text_detector")
    dtypes = stored_dtypes(path)
    assert set(dtypes.values()) == {"bfloat16"} and len(dtypes) == 299
    tensors = dict(_flat(to_torch(restore_variables(path), dtypes)))
    for key, w in _flat(ref_restore(path)):
        t = tensors[key]
        assert t.dtype == torch.bfloat16
        bits = t.view(torch.int16).numpy().view(np.uint16)
        assert bits.tobytes() == np.asarray(w).view(np.uint16).tobytes()
    crnn = os.path.join(REPO, "models", "text_recognizer")
    assert set(stored_dtypes(crnn).values()) == {"float32"}


def test_variables_pkl_round_trip(tmp_path):
    from vtd_tpu_torch.train.checkpoint import restore_variables

    rng = np.random.default_rng(0)
    tree = {"params": {"a": {"kernel": rng.normal(size=(3, 4)).astype(
        np.float32)}, "b": np.arange(5, dtype=np.int32)},
        "batch_stats": {"mean": np.zeros(4, np.float32)}}
    (tmp_path / "ckpt").mkdir()
    with open(tmp_path / "ckpt" / "variables.pkl", "wb") as fh:
        pickle.dump(tree, fh)
    shutil.copy(tmp_path / "ckpt" / "variables.pkl", tmp_path / "vars.bin")
    for path in (tmp_path / "ckpt", tmp_path / "vars.bin"):
        got = restore_variables(str(path))
        assert dict(_flat(got)).keys() == dict(_flat(tree)).keys()
        for key, want in _flat(tree):
            np.testing.assert_array_equal(dict(_flat(got))[key], want)


def test_pickle_needing_a_missing_module_names_it(tmp_path):
    from vtd_tpu_torch.train.checkpoint import restore_variables

    # a pickle that refers to a class of a module the port lacks
    (tmp_path / "variables.pkl").write_bytes(b"cno_such_module\nX\n.")
    with pytest.raises(RuntimeError, match="no_such_module"):
        restore_variables(str(tmp_path))


@pytest.mark.parametrize("module,name", [
    ("jax.numpy", "asarray"),
    ("jaxlib.xla_extension", "ArrayImpl"),
    ("flax.core.frozen_dict", "FrozenDict"),
    ("orbax.checkpoint", "PyTreeCheckpointer"),
    ("tensorstore", "TensorStore"),
    ("vtd_tpu.train.checkpoint", "restore_variables"),
])
def test_pickle_naming_a_banned_module_is_refused(tmp_path, module, name):
    """A pickle whose tree holds a class of a package the port never
    imports is refused with that module's name, installed or not."""
    import sys

    from vtd_tpu_torch.train.checkpoint import restore_variables

    tree = {"params": {"w": np.zeros(2, np.float32)}, "x": None}
    blob = pickle.dumps(tree, protocol=2)
    assert blob.endswith(b"Nu.")  # ... "x": None, SETITEMS, STOP
    # put the class where the None of "x" was
    blob = blob[:-3] + f"c{module}\n{name}\n".encode() + b"u."
    (tmp_path / "variables.pkl").write_bytes(blob)
    before = set(sys.modules)
    with pytest.raises(RuntimeError, match=module.replace(".", r"\.")):
        restore_variables(str(tmp_path))
    top = module.split(".")[0]
    assert not [m for m in set(sys.modules) - before
                if m.split(".")[0] == top]


def test_missing_checkpoint_raises(tmp_path):
    from vtd_tpu_torch.train.checkpoint import restore_variables

    with pytest.raises(FileNotFoundError):
        restore_variables(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        restore_variables(str(tmp_path))  # an empty directory


@pytest.mark.parametrize("content_size", [True, False])
def test_zstd_equals_zstandard(content_size):
    import zstandard

    from vtd_tpu_torch.train.ocdbt import zstd_decompress

    rng = np.random.default_rng(1)
    data = (rng.integers(0, 4, 300_000, np.uint8) * 60).tobytes()
    comp = zstandard.ZstdCompressor(
        level=3, write_content_size=content_size).compress(data)
    want = zstandard.ZstdDecompressor().decompress(
        comp, max_output_size=len(data))
    assert zstd_decompress(comp) == want == data
    assert zstd_decompress(comp, size_hint=len(data)) == data


def test_zstd_of_checkpoint_chunks_equals_zstandard():
    import zstandard

    from vtd_tpu_torch.train.ocdbt import OcdbtStore, zstd_decompress

    store = OcdbtStore(os.path.join(REPO, "models", "text_recognizer"))
    keys = [k for k in store.keys() if not k.endswith(b".zarray")]
    assert len(keys) == 60
    dec = zstandard.ZstdDecompressor()
    for key in keys[:12]:
        raw = store.get(key)
        assert zstd_decompress(raw) == dec.decompress(
            raw, max_output_size=1 << 26)


def test_crc32c_and_corrupt_record(tmp_path):
    from vtd_tpu_torch.train.ocdbt import OcdbtStore, crc32c

    assert crc32c(b"123456789") == 0xE3069283  # the standard check value
    src = os.path.join(REPO, "demo_models2", "crnn", "crnn_final")
    dst = tmp_path / "ckpt"
    shutil.copytree(src, dst)
    manifest = bytearray((dst / "manifest.ocdbt").read_bytes())
    manifest[20] ^= 0x01
    (dst / "manifest.ocdbt").write_bytes(bytes(manifest))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(dst)


@pytest.mark.parametrize("path", [b"../d/x", b"/etc/x", b"d/../../x"])
def test_data_file_outside_the_store_is_refused(path):
    from vtd_tpu_torch.train.ocdbt import _data_file_table, _Reader

    table = bytes([2, 0, len(b"d/ok"), len(path), 0, 0]) + b"d/ok" + path
    with pytest.raises(ValueError, match="outside the store"):
        _data_file_table(_Reader(table))
    ok = bytes([1, 4, 0]) + b"d/ok"
    assert _data_file_table(_Reader(ok)) == ["d/ok"]


@pytest.fixture(scope="module")
def tensorstore_db(tmp_path_factory):
    """An OCDBT store written by tensorstore with small B-tree nodes (so
    the tree has interior nodes) holding zarr v2 arrays of several chunks,
    with partial edge chunks, chunks never written, and bfloat16."""
    import tensorstore as ts
    root = tmp_path_factory.mktemp("ocdbt")
    base = {"driver": "ocdbt", "base": f"file://{root}",
            "config": {"max_decoded_node_bytes": 300,
                       "compression": {"id": "zstd"}}}
    rng = np.random.default_rng(3)
    arrays = {}
    for i in range(24):
        dtype = ["<f4", "<i4", "bfloat16"][i % 3]
        shape = [5 + i % 3, 7]
        values = rng.normal(size=shape).astype(np.float32) * 100
        spec = {"driver": "zarr", "kvstore": dict(base, path=f"p.a{i:02d}"),
                "metadata": {"shape": shape, "chunks": [2, 3],
                             "dtype": dtype,
                             "compressor": {"id": "zstd", "level": 1}},
                "create": True, "delete_existing": True}
        store = ts.open(spec).result()
        values = values.astype(store.dtype.numpy_dtype)
        if i % 5 == 0:
            store[:2, :3] = values[:2, :3]  # other chunks never written
        else:
            store.write(values).result()
        arrays[f"p.a{i:02d}"] = np.asarray(store.read().result())
    return root, arrays


def test_reader_walks_interior_nodes_and_chunks(tensorstore_db):
    from vtd_tpu_torch.train.ocdbt import OcdbtStore, read_zarr

    root, arrays = tensorstore_db
    store = OcdbtStore(root)
    assert store.height >= 2  # the root is an interior node
    for name, want in arrays.items():
        got, dtype = read_zarr(store, name)
        if dtype == "bfloat16":
            want = np.asarray(want).astype(np.float32)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _reference_pipeline(**kw):
    """vtd_tpu's pipeline in float32 on float32 weights (see
    tests/test_torch_pipeline.py for why)."""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.crnn import CRNN
    from vtd_tpu.models.dbnet import DBNet
    from vtd_tpu.runtime import VideoTextPipeline as RefPipeline

    pipe = RefPipeline(**kw)
    pipe.detector.model = DBNet(dtype=jnp.float32)
    pipe.detector.variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), pipe.detector.variables
    )
    if pipe.recognizer.crnn is not None:
        pipe.recognizer.crnn = CRNN(dtype=jnp.float32)
    pipe._detect_crop = pipe._build_detect_crop()
    return pipe


def _assert_close(got, want):
    assert [d["text"] for d in got] == [d["text"] for d in want]
    for g, w in zip(got, want):
        assert np.abs(np.subtract(g["bbox"], w["bbox"])).max() <= 1
        assert abs(g["detection_confidence"]
                   - w["detection_confidence"]) <= 1e-3
        assert abs(g["recognition_confidence"]
                   - w["recognition_confidence"]) <= 1e-3


@pytest.mark.parametrize("engine", ["crnn", "trocr"])
def test_default_model_paths_read_the_verify_frame(engine):
    """The reference's default model paths through the port's loaders:
    the JAX package's transcripts on the shipped frame, exactly."""
    from vtd_tpu_torch.runtime import VideoTextPipeline

    ref = np.load(VERIFY)
    rec = {"crnn": "models/text_recognizer",
           "trocr": "models/text_recognizer_trocr"}[engine]
    kw = dict(
        detector_path=os.path.join(REPO, "models", "text_detector"),
        recognizer_path=os.path.join(REPO, rec),
        use_transformer_ocr=engine == "trocr", batch_size=1, max_dets=64,
        transfer_format="yuv420",
    )
    frames = ref["frame_i420"][None]
    got = VideoTextPipeline(device="cpu", **kw).process_batch(
        frames, np.ones(1, bool))[0]
    assert [d["text"] for d in got] == [str(t) for t in ref[f"{engine}_texts"]]
    assert sorted(d["text"] for d in got) == ["123", "HELLO", "WORLD"]
    want = _reference_pipeline(**kw).process_batch(
        frames, np.ones(1, bool))[0]
    _assert_close(got, want)


def test_loaders_take_every_reference_format(tmp_path):
    """An orbax directory, a directory holding variables.pkl, a pickle
    file and a converted .pt give the same weights."""
    from vtd_tpu_torch.convert import crnn_from_jax
    from vtd_tpu_torch.runtime import TextRecognizer
    from vtd_tpu_torch.train.checkpoint import restore_variables

    orbax = os.path.join(REPO, "models", "text_recognizer")
    tree = restore_variables(orbax)
    (tmp_path / "pkl").mkdir()
    with open(tmp_path / "pkl" / "variables.pkl", "wb") as fh:
        pickle.dump(tree, fh)
    shutil.copy(tmp_path / "pkl" / "variables.pkl", tmp_path / "vars.pickle")
    torch.save(crnn_from_jax(tree), tmp_path / "crnn.pt")
    states = [
        TextRecognizer(p, use_transformer=False, device="cpu")
        .crnn.state_dict()
        for p in (orbax, str(tmp_path / "pkl"), str(tmp_path / "vars.pickle"),
                  str(tmp_path / "crnn.pt"))
    ]
    for sd in states[1:]:
        for k, v in states[0].items():
            assert torch.equal(sd[k], v), k


def test_trocr_sidecar_inside_the_checkpoint_dir(tmp_path):
    """A TrOCR checkpoint directory with its architecture in
    ``<dir>/config.json``, the other place the reference's trainer writes
    it, loads as with ``<dir>_config.json``."""
    from vtd_tpu_torch.runtime import TextRecognizer

    src = os.path.join(REPO, "models", "text_recognizer_trocr")
    dst = tmp_path / "trocr"
    shutil.copytree(src, dst)
    shutil.copy(src + "_config.json", dst / "config.json")
    a = TextRecognizer(src, use_transformer=True, device="cpu").transformer
    b = TextRecognizer(str(dst), use_transformer=True,
                       device="cpu").transformer
    assert a.cfg == b.cfg and a.cfg.image_size == 48
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this checks the restore onto it")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_restore_onto_the_card(cuda_device):
    """The trained checkpoints restored by the port's reader land on the
    card in the stored bf16 bits (detector) and float32 (CRNN), and the
    trained pipeline reads the shipped frame there."""
    from vtd_tpu_torch.runtime import VideoTextPipeline
    from vtd_tpu_torch.train.checkpoint import (
        restore_variables, stored_dtypes, to_torch,
    )

    det = os.path.join(REPO, "models", "text_detector")
    tree = to_torch(restore_variables(det), stored_dtypes(det))
    on_card = {k: v.to(cuda_device) for k, v in _flat(tree)}
    for key, t in on_card.items():
        assert t.dtype == torch.bfloat16 and t.is_cuda
        assert torch.equal(t.cpu(), dict(_flat(tree))[key])
    ref = np.load(VERIFY)
    pipe = VideoTextPipeline(
        detector_path=det,
        recognizer_path=os.path.join(REPO, "models", "text_recognizer"),
        use_transformer_ocr=False, batch_size=2, max_dets=64,
        transfer_format="yuv420",
    )
    from vtd_tpu_torch.convert import dbnet_from_jax

    want = dbnet_from_jax(restore_variables(det))
    for key, value in pipe.detector.model.state_dict().items():
        assert value.is_cuda, key
        w = want[key]
        if w.is_floating_point():
            assert value.dtype == torch.bfloat16, key
            w = w.to(torch.bfloat16)  # exact: the stored values are bf16
        assert torch.equal(value.cpu(), w), key
    out = pipe.process_batch(np.stack([ref["frame_i420"]] * 2),
                             np.ones(2, bool))
    for dets in out:
        assert sorted(d["text"] for d in dets) == ["123", "HELLO", "WORLD"]
