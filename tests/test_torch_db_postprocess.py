"""The port's DB postprocess against ``vtd_tpu.ops.db_postprocess``.

The same numpy maps go through both packages. On the CPU the reference
labels components with its XLA scan fallback and the port with the plain
twin of its CUDA kernel; both must give the same labels. Detections must
agree slot for slot: valid masks and slot order exactly, boxes and
polygons within 1e-3 px, scores within 1e-5.
"""
import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _rect_map(size, rects, value=0.95):
    m = np.zeros((size, size), np.float32)
    for cx, cy, w, h, ang in rects:
        box = cv2.boxPoints(((cx, cy), (w, h), ang))
        cv2.fillPoly(m, [np.round(box).astype(np.int32)], value)
    return m


def _cc_maps(size):
    rng = np.random.default_rng(size)
    s = size / 64
    maps = {
        "blobs": _rect_map(size, [(16 * s, 12 * s, 20 * s, 8 * s, 0),
                                  (44 * s, 46 * s, 26 * s, 10 * s, 20)]) > 0.5,
        "noise": rng.random((size, size)) < 0.45,
    }
    stairs = np.zeros((size, size), bool)
    for i in range(0, size - 2, 2):
        stairs[i:i + 2, i:i + 2] = True
    maps["staircase"] = stairs
    # thin rotated banners, as tests/test_db_postprocess.py scales them
    for ang in (45, -45, 30, 70, 10):
        maps[f"banner{ang}"] = _rect_map(
            size, [(size / 2, size / 2, 0.8 * size, 3, ang)]
        ) > 0.5
    return maps


@pytest.mark.parametrize("size", [64, 96])
def test_connected_components_matches_reference(size):
    import jax
    import jax.numpy as jnp

    from vtd_tpu.ops.db_postprocess import connected_components as ref_cc
    from vtd_tpu_torch.ops.db_postprocess import connected_components

    maps = _cc_maps(size)
    stack = np.stack(list(maps.values()))
    got = connected_components(torch.from_numpy(stack)).numpy()
    want = np.asarray(jax.jit(jax.vmap(ref_cc))(jnp.asarray(stack)))
    for name, g, w in zip(maps, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _pp_maps(size):
    s = size / 640
    sets = [
        [(320, 320, 200, 60, 0)],
        [(150, 100, 120, 40, 0), (450, 400, 220, 70, -30),
         (320, 550, 90, 45, 60)],
        [(320, 320, 500, 28, -45)],
        [(320, 320, 580, 40, 20)],
        [(200, 150, 180, 50, 25), (470, 470, 150, 90, 80)],
    ]
    maps = [
        _rect_map(size, [(cx * s, cy * s, w * s, h * s, a)
                         for cx, cy, w, h, a in rects])
        for rects in sets
    ]
    # a map with graded probabilities and a frame-filling ring
    rng = np.random.default_rng(size)
    ring = np.zeros((size, size), np.float32)
    ring[2:-2, 2:5] = ring[2:-2, -5:-2] = 0.9
    ring[2:5, 2:-2] = ring[-5:-2, 2:-2] = 0.9
    ring[size // 3:size // 3 + size // 12, size // 6:size // 2] = (
        0.55 + 0.4 * rng.random((size // 12, size // 2 - size // 6))
    )
    maps.append(ring)
    return np.stack(maps)


@pytest.mark.parametrize("size,max_box_frac", [(160, 0.95), (320, 1.0)])
def test_db_postprocess_matches_reference(size, max_box_frac):
    import jax
    import jax.numpy as jnp

    from vtd_tpu.ops.db_postprocess import db_postprocess as ref_pp
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess

    maps = _pp_maps(size)
    got = db_postprocess(
        torch.from_numpy(maps), 0.5, max_dets=16, max_box_frac=max_box_frac
    )
    want = jax.vmap(
        lambda p: ref_pp(p, 0.5, max_dets=16, max_box_frac=max_box_frac)
    )(jnp.asarray(maps))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].any()
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["areas"], want["areas"])
    for key in ("boxes", "polygons", "xmin", "xmax", "ymin", "ymax"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-3, err_msg=key)
    # A score is the mean over the integer pixel window floor(x1)..ceil(x2)
    # of its box. Where a box edge sits on an integer, a last-bit
    # difference in the edge (XLA may fuse u*c - v*s into one FMA) moves
    # the window by a pixel; there the scores are compared with the box
    # means on each side's own window instead.
    def window(boxes):
        return np.concatenate(
            [np.floor(boxes[..., :2]), np.ceil(boxes[..., 2:])], -1
        )

    same = (window(got["boxes"]) == window(want["boxes"])).all(-1)
    np.testing.assert_allclose(
        got["scores"][same], want["scores"][same], atol=1e-5
    )
    for i, j in np.argwhere(~same):
        edges = np.concatenate([got["boxes"][i, j], want["boxes"][i, j]])
        assert np.abs(edges - np.round(edges)).max() < 1e-3
        for post in (got, want):
            x1, y1, x2, y2 = window(post["boxes"][i, j]).astype(int)
            mean = maps[i, y1:y2, x1:x2].astype(np.float64).mean()
            assert abs(post["scores"][i, j] - mean) < 1e-5
    assert same.mean() > 0.9


def test_extract_detections_matches_reference():
    from vtd_tpu.ops.db_postprocess import extract_detections as ref_extract
    from vtd_tpu_torch.ops.db_postprocess import extract_detections

    rng = np.random.default_rng(1)
    post = {
        "boxes": rng.random((8, 4)).astype(np.float32) * 640,
        "polygons": rng.random((8, 4, 2)).astype(np.float32) * 640,
        "scores": rng.random(8).astype(np.float32),
        "valid": rng.random(8) < 0.7,
    }
    post["boxes"][:, 2:] = post["boxes"][:, :2] + 40 + 100 * rng.random((8, 2))
    assert extract_detections(post, 1280, 720) == ref_extract(post, 1280, 720)
