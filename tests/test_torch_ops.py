"""The port's preprocess and crop ops against ``vtd_tpu.ops``.

Tolerances: ``yuv420_to_bgr`` exact; ``preprocess_frames`` within 1e-5
after normalisation on the shape the main path ships (640x360 -> 640^2);
crops within 1e-5 (float32 sums in another order), the gather crop 3e-5
where the reference's compiled code rounds its sample coordinates without
an FMA, polygon rectification 1e-4; ``iou_matrix`` within 1e-6, ``nms``
keep masks and ``temporal_dedup`` tracks equal; ``decode_batch`` texts
equal, confidences 1e-6; ``db_postprocess_batch`` as in
tests/test_torch_db_postprocess.py and its profiling cuts exactly;
``resize_with_padding`` 1e-3 in float (uint8: truncation may move a value
by one); ``normalize_frame`` / ``denormalize_frame`` exact. Also: the
port's ``ops`` exports the reference's 17 names.
"""
import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _frames(n=2, h=360, w=640, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    cv2.putText(f[0], "PORT 123", (40, 200), cv2.FONT_HERSHEY_SIMPLEX, 3,
                (10, 240, 30), 5)
    return f


def test_yuv420_to_bgr_exact():
    import jax.numpy as jnp

    from vtd_tpu.ops.preprocess import yuv420_to_bgr as ref
    from vtd_tpu_torch.ops.preprocess import yuv420_to_bgr

    packed = np.stack(
        [cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420) for f in _frames()]
    )
    packed[1] = np.random.default_rng(1).integers(0, 256, packed[1].shape)
    got = yuv420_to_bgr(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref(jnp.asarray(packed))))


def test_preprocess_frames_on_shipped_shape():
    import jax.numpy as jnp

    from vtd_tpu.ops.preprocess import preprocess_frames as ref
    from vtd_tpu_torch.ops.preprocess import preprocess_frames

    frames = _frames()
    want = np.asarray(
        ref(jnp.asarray(frames), out_size=640, dtype=jnp.float32)
    )
    got = preprocess_frames(
        torch.from_numpy(frames), 640, dtype=torch.float32
    ).numpy()
    assert got.shape == want.shape == (2, 640, 640, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_crop_and_resize_boxes_mm_matches_reference():
    import jax
    import jax.numpy as jnp

    from vtd_tpu.ops.crop import crop_and_resize_boxes_mm as ref
    from vtd_tpu_torch.ops.crop import crop_and_resize_boxes_mm

    frames = _frames(h=120, w=200)
    rng = np.random.default_rng(3)
    xy = rng.random((2, 6, 2)) * [150, 90]
    wh = 5 + rng.random((2, 6, 2)) * [80, 40]
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 0] = [-3.0, -2.0, 210.0, 130.0]  # clamps at the frame edge
    valid = rng.random((2, 6)) < 0.7
    want = np.asarray(jax.vmap(ref)(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(valid)
    ))
    got = crop_and_resize_boxes_mm(
        torch.from_numpy(frames), torch.from_numpy(boxes),
        torch.from_numpy(valid),
    ).numpy()
    assert got.shape == (2, 6, 32, 128, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not got[~valid].any()


def _boxes(seed, k=24):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (k, 2)).astype(np.float32)
    wh = rng.uniform(5, 40, (k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[k // 2:k // 2 + 4] = boxes[:4] + 1.0  # near-duplicates
    boxes[-1] = [10, 10, 10, 30]  # zero area
    return boxes, rng.random(k).astype(np.float32), rng.random(k) < 0.8


def test_iou_matrix_and_nms_match_reference():
    import jax.numpy as jnp

    from vtd_tpu.ops.nms import iou_matrix as ref_iou, nms as ref_nms
    from vtd_tpu_torch.ops.nms import iou_matrix, nms

    for seed in range(3):
        boxes, scores, valid = _boxes(seed)
        got = iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes[:7]))
        want = np.asarray(ref_iou(jnp.asarray(boxes), jnp.asarray(boxes[:7])))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        for thr in (0.3, 0.5):
            keep = nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), thr)
            want = np.asarray(ref_nms(
                jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                thr))
            np.testing.assert_array_equal(keep.numpy(), want)
            assert keep.any() and not keep[~torch.from_numpy(valid)].any()
    none = nms(torch.from_numpy(boxes), torch.from_numpy(scores),
               torch.zeros(len(boxes), dtype=torch.bool))
    assert not none.any()


def test_temporal_dedup_matches_reference():
    from vtd_tpu.ops.nms import temporal_dedup as ref_dedup
    from vtd_tpu_torch.ops.nms import temporal_dedup

    rng = np.random.default_rng(9)
    words = ["EXIT", "Gate 12", "a", " ", "OPEN"]
    frames = []
    for fn in range(0, 40, 3):
        dets = []
        for j, word in enumerate(words):
            if rng.random() < 0.7:
                x, y = 20 + 60 * j + int(rng.integers(-3, 4)), 30 + 2 * (fn // 9)
                dets.append({
                    "bbox": [x, y, x + 50, y + 20], "text": word,
                    "detection_confidence": float(rng.random()),
                    "recognition_confidence": float(rng.random()),
                })
        if fn == 21:  # the same word far away: a track of its own
            dets.append({"bbox": [300, 200, 350, 220], "text": "EXIT",
                         "detection_confidence": 0.9,
                         "recognition_confidence": 0.8})
        frames.append({"frame_number": fn, "detections": dets})
    got, want = temporal_dedup(frames), ref_dedup(frames)
    assert got == want and len(got) > len(words) - 1
    assert all(t["text"].strip() for t in got)
    assert temporal_dedup(frames, iou_threshold=0.99) == ref_dedup(
        frames, iou_threshold=0.99)
    assert temporal_dedup([]) == []


def test_ops_export_the_reference_names():
    import vtd_tpu.ops as ref
    import vtd_tpu_torch.ops as ops

    assert ops.__all__ == ref.__all__ and len(ops.__all__) == 17
    for name in ops.__all__:
        assert callable(getattr(ops, name)) or name.startswith("IMAGENET")
    assert ops.IMAGENET_MEAN == ref.IMAGENET_MEAN
    assert ops.IMAGENET_STD == ref.IMAGENET_STD


def _crop_inputs(seed=3, k=6):
    frames = _frames(h=120, w=200)
    rng = np.random.default_rng(seed)
    xy = rng.random((2, k, 2)) * [150, 90]
    wh = 5 + rng.random((2, k, 2)) * [80, 40]
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 0] = [-3.0, -2.0, 210.0, 130.0]  # clamps at the frame edge
    valid = rng.random((2, k)) < 0.7
    return frames, boxes, valid


def test_crop_and_resize_boxes_matches_reference():
    import jax
    import jax.numpy as jnp

    from vtd_tpu.ops.crop import crop_and_resize_boxes as ref
    from vtd_tpu_torch.ops import crop_and_resize_boxes

    frames, boxes, valid = _crop_inputs()
    want = np.asarray(jax.vmap(ref)(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(valid)))
    got = crop_and_resize_boxes(
        torch.from_numpy(frames), torch.from_numpy(boxes),
        torch.from_numpy(valid)).numpy()
    assert got.shape == (2, 6, 32, 128, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    one = crop_and_resize_boxes(
        torch.from_numpy(frames[1]), torch.from_numpy(boxes[1]),
        torch.from_numpy(valid[1]), out_h=16, out_w=48).numpy()
    want1 = np.asarray(ref(jnp.asarray(frames[1]), jnp.asarray(boxes[1]),
                           jnp.asarray(valid[1]), out_h=16, out_w=48))
    # this compilation of the reference rounds the sample coordinates
    # without an FMA: a last-bit coordinate (2^-17 at 100 px) moves a
    # sample by up to that fraction of a 255-step, 3e-5 in [0, 1]
    np.testing.assert_allclose(one, want1, atol=3e-5)


def test_rectify_polygons_matches_reference():
    import jax
    import jax.numpy as jnp

    from vtd_tpu.ops.crop import rectify_polygons as ref
    from vtd_tpu_torch.ops import rectify_polygons

    frames = _frames(h=120, w=200)
    rng = np.random.default_rng(4)
    polys = []
    for _ in range(2 * 5):
        box = cv2.boxPoints(((rng.uniform(30, 170), rng.uniform(20, 100)),
                             (rng.uniform(10, 90), rng.uniform(8, 40)),
                             rng.uniform(-80, 80)))
        polys.append(box)
    polys = np.asarray(polys, np.float32).reshape(2, 5, 4, 2)
    polys[1, 4] = [[-5, -5], [250, -5], [250, 140], [-5, 140]]  # clamps
    valid = rng.random((2, 5)) < 0.8
    want = np.asarray(jax.vmap(ref)(
        jnp.asarray(frames), jnp.asarray(polys), jnp.asarray(valid)))
    got = rectify_polygons(
        torch.from_numpy(frames), torch.from_numpy(polys),
        torch.from_numpy(valid)).numpy()
    assert got.shape == (2, 5, 32, 128, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    one = rectify_polygons(torch.from_numpy(frames[0]),
                           torch.from_numpy(polys[0]),
                           torch.from_numpy(valid[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_decode_batch_matches_reference():
    import jax.numpy as jnp

    from vtd_tpu.ops.ctc import decode_batch as ref
    from vtd_tpu_torch.ops import decode_batch

    rng = np.random.default_rng(5)
    logits = rng.normal(size=(5, 31, 97)).astype(np.float32) * 4
    logits[0, :, 0] = 50.0  # all blank: empty text, confidence 0
    got = decode_batch(torch.from_numpy(logits))
    want = ref(jnp.asarray(logits))
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want],
                               atol=1e-6)
    assert got[0] == ("", 0.0)


def _post_maps(size=128):
    maps = np.zeros((3, size, size), np.float32)
    for i, rects in enumerate([
        [((40, 30), (50, 14), 0), ((90, 90), (60, 18), -30)],
        [((64, 64), (100, 10), 45)],
        [],
    ]):
        for rect in rects:
            cv2.fillPoly(maps[i], [np.round(cv2.boxPoints(rect)).astype(
                np.int32)], 0.9)
    return maps


def test_db_postprocess_batch_and_stage_cuts_match_reference():
    import jax
    import jax.numpy as jnp

    from vtd_tpu.ops.db_postprocess import db_postprocess as ref_pp
    from vtd_tpu.ops.db_postprocess import db_postprocess_batch as ref_batch
    from vtd_tpu_torch.ops import db_postprocess, db_postprocess_batch

    maps = _post_maps()
    kw = dict(max_dets=8, max_box_frac=0.95)
    got = db_postprocess_batch(torch.from_numpy(maps), 0.5, **kw)
    want = {k: np.asarray(v) for k, v in
            ref_batch(jnp.asarray(maps), 0.5, **kw).items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert want["valid"].sum() == 3
    for key in ("boxes", "polygons", "areas"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-3)
    for stage, keys in (("cc", ["labels"]),
                        ("topk", ["roots", "areas", "valid"]),
                        ("boundary", ["xs", "ys", "pmask", "valid"])):
        cut = db_postprocess(torch.from_numpy(maps), 0.5, stage=stage, **kw)
        ref_cut = jax.vmap(
            lambda p, stage=stage: ref_pp(p, 0.5, stage=stage, **kw)
        )(jnp.asarray(maps))
        assert sorted(cut) == sorted(keys) == sorted(ref_cut), stage
        for key in keys:
            w = np.asarray(ref_cut[key])
            g = cut[key].numpy()
            assert g.dtype == w.dtype, (stage, key)
            np.testing.assert_array_equal(g, w, err_msg=f"{stage} {key}")
    with pytest.raises(ValueError, match="stage"):
        db_postprocess(torch.from_numpy(maps), 0.5, stage="sort")


@pytest.mark.parametrize("shape", [(90, 160), (200, 120), (64, 64)])
def test_resize_with_padding_matches_reference(shape):
    import jax.numpy as jnp

    from vtd_tpu.ops.preprocess import resize_with_padding as ref
    from vtd_tpu_torch.ops.preprocess import resize_with_padding

    img = _frames(1, *shape)[0]
    fimg = img.astype(np.float32)
    got = resize_with_padding(torch.from_numpy(fimg), 96).numpy()
    want = np.asarray(ref(jnp.asarray(fimg), 96))
    assert got.shape == want.shape == (96, 96, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    # uint8 keeps its dtype; float -> uint8 truncates, so a value a last
    # bit away from an integer may land one apart
    got8 = resize_with_padding(torch.from_numpy(img), 96).numpy()
    want8 = np.asarray(ref(jnp.asarray(img), 96))
    assert got8.dtype == want8.dtype == np.uint8
    diff = np.abs(got8.astype(int) - want8.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_normalize_and_denormalize_frame_match_reference():
    import jax.numpy as jnp

    from vtd_tpu.ops.preprocess import denormalize_frame as ref_de
    from vtd_tpu.ops.preprocess import normalize_frame as ref_norm
    from vtd_tpu_torch.ops.preprocess import (
        denormalize_frame, normalize_frame,
    )

    img = _frames(1, 40, 60)[0]
    got = normalize_frame(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_norm(jnp.asarray(img))))
    x = np.random.default_rng(8).uniform(-0.2, 1.2, (40, 60, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        denormalize_frame(torch.from_numpy(x)).numpy(),
        np.asarray(ref_de(jnp.asarray(x))))
