"""The reference's single-map rank on the port's per-map ops.

``vtd_tpu``'s kernels and per-map ops take one map ([H, W], or one image
[H, W, 3] with [K, ...] boxes) and its pipeline ``vmap``s them. The port's
take that rank as well as a batch. The same numpy inputs, the maps of the
reference's own tests (``tests/test_db_postprocess.py``,
``tests/test_pallas_kernels.py``, ``tests/test_ops.py``), go through
``vtd_tpu``'s function on one map (``interpret=True`` for the two Pallas
kernels) and through the port's 2-D call: labels and ``valid`` exactly
equal; boxes and polygons within 1e-3 px, scores within 1e-5 and crops
within 1e-5, the tolerances of the port's batched parity tests, with
their integer box edge case. A 2-D call equals row 0 of the batched
call, and any other rank raises ``ValueError``.
"""
import functools

import numpy as np
import pytest
import torch
from test_db_postprocess import _synthetic_map

torch.set_num_threads(2)


def _counts_map():
    """``tests/test_db_postprocess.py:54``."""
    m = np.zeros((64, 64), bool)
    m[5:15, 5:25] = True
    m[40:50, 30:60] = True
    m[20:22, 50:52] = True
    return m


def _adversarial_maps(size=160):
    """``tests/test_db_postprocess.py:69-95``: a spiral of 3 px arms, a
    diagonal staircase and dense noise."""
    spiral = np.zeros((size, size), bool)
    r, c = size // 2, size // 2
    step, length = 3, 4
    dr, dc = 0, 1
    for _ in range(18):
        rr, cc = r + dr * length, c + dc * length
        lo_r, hi_r = sorted((r, rr))
        lo_c, hi_c = sorted((c, cc))
        spiral[max(lo_r, 0):min(hi_r + step, size),
               max(lo_c, 0):min(hi_c + step, size)] = True
        r, c = rr, cc
        dr, dc = dc, -dr
        length += 4
    stairs = np.zeros((size, size), bool)
    for i in range(0, size - 2, 2):
        stairs[i:i + 2, i:i + 2] = True
    rng = np.random.default_rng(7)
    return {"spiral": spiral, "staircase": stairs,
            "noise": rng.random((size, size)) < 0.45}


def _kernel_maps():
    """The counts map, ``tests/test_pallas_kernels.py``'s maps (32x32
    noise, 48x48 blocks and staircase) and the adversarial shapes."""
    blocks = np.zeros((48, 48), bool)
    blocks[4:10, 4:30] = True
    blocks[20:30, 10:40] = True
    stairs = np.zeros((48, 48), bool)
    for i in range(0, 46, 2):
        stairs[i:i + 2, i:i + 2] = True
    return {"counts": _counts_map(),
            "noise32": np.random.default_rng(0).random((32, 32)) > 0.5,
            "blocks48": blocks, "stairs48": stairs, **_adversarial_maps()}


KERNEL_MAPS = _kernel_maps()


def _label_seeds(m):
    h, w = m.shape
    perm = np.random.default_rng(h * w).permutation(h * w)
    return {"ident": np.arange(h * w, dtype=np.int32).reshape(h, w),
            "perm": perm.astype(np.int32).reshape(h, w)}


def _other(m):
    """A second map of the same shape for the batched call's row 1."""
    return np.random.default_rng(m.size).random(m.shape) < 0.5


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("name", sorted(KERNEL_MAPS))
def test_segmented_cc_round_one_map_matches_pallas(name, diag):
    import jax.numpy as jnp

    from vtd_tpu.ops.pallas_kernels import segmented_cc_round as ref_round
    from vtd_tpu_torch.ops.cc_kernels import segmented_cc_round

    m = KERNEL_MAPS[name]
    for seed, lbl in _label_seeds(m).items():
        want = np.asarray(ref_round(jnp.asarray(m), jnp.asarray(lbl),
                                    diag=diag, interpret=True))
        got = segmented_cc_round(torch.from_numpy(m), torch.from_numpy(lbl),
                                 diag)
        assert got.shape == m.shape and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=seed)
        batch = segmented_cc_round(
            torch.from_numpy(np.stack([m, _other(m)])),
            torch.from_numpy(np.stack([lbl, lbl])), diag)
        assert torch.equal(got, batch[0])


@pytest.mark.parametrize("iters", [1, 4, 8])
@pytest.mark.parametrize("name", sorted(KERNEL_MAPS))
def test_neighbor_min_sweeps_one_map_matches_pallas(name, iters):
    import jax.numpy as jnp

    from vtd_tpu.ops.pallas_kernels import neighbor_min_sweeps as ref_sweeps
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps

    m = KERNEL_MAPS[name]
    for seed, lbl in _label_seeds(m).items():
        want = np.asarray(ref_sweeps(jnp.asarray(m), jnp.asarray(lbl),
                                     iters=iters, interpret=True))
        got = neighbor_min_sweeps(torch.from_numpy(m), torch.from_numpy(lbl),
                                  iters=iters)
        assert got.shape == m.shape and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=seed)
        batch = neighbor_min_sweeps(
            torch.from_numpy(np.stack([m, _other(m)])),
            torch.from_numpy(np.stack([lbl, lbl])), iters)
        assert torch.equal(got, batch[0])


@functools.lru_cache(maxsize=None)
def _ref_jit(name, **kw):
    """The reference's function ``name`` of ``vtd_tpu.ops.db_postprocess``
    under ``jax.jit`` with static keywords (its eager run of a while loop
    takes seconds a call)."""
    import importlib

    import jax

    ref = importlib.import_module("vtd_tpu.ops.db_postprocess")
    return jax.jit(functools.partial(getattr(ref, name), **kw))


def _ref(name, x, **kw):
    import jax.numpy as jnp

    out = _ref_jit(name, **kw)(jnp.asarray(x))
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(_adversarial_maps()))
def test_connected_components_scan_one_map(name):
    """``tests/test_db_postprocess.py:101``: the exact-mode scan."""
    from vtd_tpu_torch.ops.db_postprocess import connected_components_scan

    m = _adversarial_maps()[name]
    want = _ref("connected_components_scan", m, max_rounds=32)
    got = connected_components_scan(torch.from_numpy(m), max_rounds=32)
    assert got.shape == (m.size,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    batch = connected_components_scan(
        torch.from_numpy(np.stack([m, _other(m)])), max_rounds=32)
    assert torch.equal(got, batch[0])


@pytest.mark.parametrize("backend", ["auto", "scan", "pallas", "pallas-auto",
                                     "xla"])
def test_connected_components_one_map_every_backend(backend):
    """``tests/test_db_postprocess.py:54`` and
    ``tests/test_pallas_kernels.py:82``. The reference's dense backends
    are held by its "xla" schedule: its "pallas" needs a TPU, and the
    three names are one schedule in the port ("scan" and "auto" are one
    in both)."""
    from vtd_tpu_torch.ops.db_postprocess import connected_components

    ref_backend = "auto" if backend in ("auto", "scan") else "xla"
    maps = {"counts": _counts_map(), **_adversarial_maps(96)}
    for name, m in maps.items():
        want = _ref("connected_components", m, backend=ref_backend)
        got = connected_components(torch.from_numpy(m), backend=backend)
        assert got.shape == (m.size,) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        batch = connected_components(
            torch.from_numpy(np.stack([m, _other(m)])), backend=backend)
        assert torch.equal(got, batch[0]), name
    labels = connected_components(torch.from_numpy(_counts_map()),
                                  backend=backend).numpy()
    assert len(np.unique(labels.reshape(64, 64)[_counts_map()])) == 3


def _ring_map():
    """``tests/test_db_postprocess.py:258-263``: a frame-filling ring and
    a text-sized blob."""
    prob = np.zeros((640, 640), np.float32)
    prob[2:638, 2:6] = 0.9
    prob[2:638, 634:638] = 0.9
    prob[2:6, 2:638] = 0.9
    prob[634:638, 2:638] = 0.9
    prob[300:340, 100:300] = 0.9
    return prob


def _post_maps():
    """The probability maps behind ``tests/test_db_postprocess.py:124-281``,
    with the keywords each case passes."""
    rect_sets = {
        "rect0": [(320, 320, 200, 60, 0)],
        "rect25": [(200, 150, 180, 50, 25)],
        "three": [(150, 100, 120, 40, 0), (450, 400, 220, 70, -30),
                  (320, 550, 90, 45, 60)],
        "banner45": [(320, 320, 400, 20, 45)],
        "banner-45": [(320, 320, 500, 14, -45)],
        "banner10": [(320, 320, 580, 40, 10)],
        "banner20": [(320, 320, 580, 40, 20)],
        "banner30": [(320, 320, 500, 14, 30)],
        "banner70": [(320, 320, 500, 14, 70)],
        "banner60": [(320, 320, 400, 20, 60)],
        "close_lines": [(320, 200, 300, 30, 0), (320, 236, 300, 30, 0)],
        "extract": [(320, 320, 200, 60, 10)],
    }
    out = {k: (_synthetic_map(v), {}) for k, v in rect_sets.items()}
    small = np.zeros((640, 640), np.float32)
    small[10:15, 10:15] = 0.9
    small[100:150, 100:300] = 0.9
    scores = np.zeros((640, 640), np.float32)
    scores[100:200, 100:400] = 0.8
    few = np.zeros((640, 640), np.float32)
    few[100:160, 100:400] = 0.9
    few[300:360, 200:500] = 0.9
    out.update({
        "small": (small, {}),
        "scores": (scores, {}),
        "few": (few, {}),  # max_dets=64 in the reference's case: the default
        "empty": (np.zeros((640, 640), np.float32), {}),
        "ring": (_ring_map(), {}),
        "ring_unfiltered": (_ring_map(), {"max_box_frac": 1.0}),
    })
    return out


POST_MAPS = _post_maps()


def _window(boxes):
    return np.concatenate([np.floor(boxes[..., :2]),
                           np.ceil(boxes[..., 2:])], -1)


def _assert_post_equal(got, want, prob):
    """Detections slot for slot, as the batched parity test holds them."""
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["areas"], want["areas"])
    for key in ("boxes", "polygons", "xmin", "xmax", "ymin", "ymax"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-3,
                                   err_msg=key)
    # a box edge on an integer may move the score's pixel window by one
    # (a last-bit difference); there each score is its own window's mean
    same = (_window(got["boxes"]) == _window(want["boxes"])).all(-1)
    np.testing.assert_allclose(got["scores"][same], want["scores"][same],
                               atol=1e-5)
    for j in np.flatnonzero(~same):
        edges = np.concatenate([got["boxes"][j], want["boxes"][j]])
        assert np.abs(edges - np.round(edges)).max() < 1e-3
        for post in (got, want):
            x1, y1, x2, y2 = _window(post["boxes"][j]).astype(int)
            mean = prob[y1:y2, x1:x2].astype(np.float64).mean()
            assert abs(post["scores"][j] - mean) < 1e-5


@pytest.mark.parametrize("name", sorted(POST_MAPS))
def test_db_postprocess_one_map_matches_reference(name):
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess

    prob, kw = POST_MAPS[name]
    want = _ref("db_postprocess", prob, bin_thresh=0.5, **kw)
    got = db_postprocess(torch.from_numpy(prob), 0.5, **kw)
    k = kw.get("max_dets", 64)
    assert got["boxes"].shape == (k, 4) and got["valid"].shape == (k,)
    _assert_post_equal({k: v.numpy() for k, v in got.items()}, want, prob)


def test_db_postprocess_one_map_takes_a_0d_threshold():
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess

    prob, _ = POST_MAPS["three"]
    a = db_postprocess(torch.from_numpy(prob), 0.5)
    b = db_postprocess(torch.from_numpy(prob), torch.tensor(0.5))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["valid"].sum()) == 3


@pytest.mark.parametrize("name", ["three", "banner20", "ring"])
def test_db_postprocess_one_map_is_row_0_of_the_batch(name):
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess

    prob, kw = POST_MAPS[name]
    other, _ = POST_MAPS["few"]
    one = db_postprocess(torch.from_numpy(prob), 0.5, **kw)
    batch = db_postprocess(torch.from_numpy(np.stack([prob, other])), 0.5,
                           **kw)
    assert set(one) == set(batch)
    for key in one:
        assert torch.equal(one[key], batch[key][0]), key


@pytest.mark.parametrize("stage,keys", [
    ("cc", ["labels"]), ("topk", ["roots", "areas", "valid"]),
    ("boundary", ["xs", "ys", "pmask", "valid"]),
])
def test_db_postprocess_one_map_stage_cuts(stage, keys):
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess

    prob, _ = POST_MAPS["three"]
    want = _ref("db_postprocess", prob, bin_thresh=0.5, stage=stage)
    got = db_postprocess(torch.from_numpy(prob), 0.5, stage=stage)
    assert sorted(got) == sorted(keys) == sorted(want)
    for key in keys:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key].numpy(), want[key],
                                      err_msg=key)


@pytest.mark.parametrize("name", ["extract", "three", "empty", "ring"])
def test_extract_detections_of_one_map_matches_reference(name):
    """The reference's one-frame composition,
    ``extract_detections(db_postprocess(prob_map), w, h)``
    (``tests/test_db_postprocess.py:210``)."""
    from vtd_tpu.ops.db_postprocess import extract_detections as ref_extract
    from vtd_tpu_torch.ops.db_postprocess import (
        db_postprocess, extract_detections,
    )

    prob, kw = POST_MAPS[name]
    want = ref_extract(_ref("db_postprocess", prob, bin_thresh=0.5, **kw),
                       orig_width=1280, orig_height=720)
    got = extract_detections(db_postprocess(torch.from_numpy(prob), 0.5, **kw),
                             orig_width=1280, orig_height=720)
    assert [d["bbox"] for d in got] == [d["bbox"] for d in want]
    assert [d["polygon"] for d in got] == [d["polygon"] for d in want]
    np.testing.assert_allclose([d["confidence"] for d in got],
                               [d["confidence"] for d in want], atol=1e-5)
    assert len(got) == {"extract": 1, "three": 3, "empty": 0, "ring": 1}[name]


def test_db_postprocess_batch_stays_batched():
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess_batch

    prob, _ = POST_MAPS["rect0"]
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        db_postprocess_batch(torch.from_numpy(prob), 0.5)


def test_crop_and_resize_boxes_mm_one_image_matches_reference():
    """``tests/test_ops.py:67``: one 480x640 image, two boxes."""
    import jax.numpy as jnp

    from vtd_tpu.ops.crop import crop_and_resize_boxes_mm as ref_crop
    from vtd_tpu_torch.ops.crop import crop_and_resize_boxes_mm

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (480, 640, 3), np.uint8)
    boxes = np.array([[100, 50, 300, 120], [0, 0, 64, 32],
                      [-3, -2, 650, 490], [10.5, 20.25, 90.75, 41.0]],
                     np.float32)
    valid = np.array([True, True, True, False])
    want = np.asarray(ref_crop(jnp.asarray(img), jnp.asarray(boxes),
                               jnp.asarray(valid)))
    got = crop_and_resize_boxes_mm(torch.from_numpy(img),
                                   torch.from_numpy(boxes),
                                   torch.from_numpy(valid))
    assert got.shape == (4, 32, 128, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert not got[3].any()
    batch = crop_and_resize_boxes_mm(
        torch.from_numpy(np.stack([img, img[::-1].copy()])),
        torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])),
        torch.from_numpy(np.stack([valid, valid])))
    assert torch.equal(got, batch[0])


def _wrong_ranks():
    """(function, arguments of a rank it does not take, the ranks named
    in the error)."""
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, segmented_cc_round,
    )
    from vtd_tpu_torch.ops.crop import (
        crop_and_resize_boxes, crop_and_resize_boxes_mm, rectify_polygons,
    )
    from vtd_tpu_torch.ops.db_postprocess import (
        connected_components, connected_components_scan, db_postprocess,
    )

    b1, l1 = torch.zeros(8, dtype=torch.bool), torch.zeros(8, dtype=torch.int32)
    b4 = torch.zeros(1, 1, 8, 8, dtype=torch.bool)
    l4 = torch.zeros(1, 1, 8, 8, dtype=torch.int32)
    img2, img5 = torch.zeros(8, 8), torch.zeros(1, 1, 8, 8, 3)
    boxes, valid = torch.zeros(1, 1, 1, 4), torch.zeros(1, 1, 1, dtype=bool)
    out = []
    for fn in (segmented_cc_round, neighbor_min_sweeps):
        out += [(fn, (b1, l1), "H, W"), (fn, (b4, l4), "H, W")]
    for fn in (connected_components_scan, connected_components):
        out += [(fn, (b1,), "H, W"), (fn, (b4,), "H, W")]
    out += [(db_postprocess, (torch.zeros(8),), "H, W"),
            (db_postprocess, (torch.zeros(1, 1, 8, 8),), "H, W")]
    for fn in (crop_and_resize_boxes_mm, crop_and_resize_boxes):
        out += [(fn, (img2, boxes[0, 0], valid[0, 0]), "H, W, 3"),
                (fn, (img5, boxes, valid), "H, W, 3")]
    out += [(rectify_polygons, (img5, torch.zeros(1, 1, 1, 4, 2), valid),
             "H, W, 3")]
    return out


@pytest.mark.parametrize("case", range(len(_wrong_ranks())))
def test_other_ranks_raise(case):
    fn, args, shape = _wrong_ranks()[case]
    with pytest.raises(ValueError) as err:
        fn(*args)
    assert f"[{shape}]" in str(err.value) and f"[B, {shape}]" in str(
        err.value), err.value
