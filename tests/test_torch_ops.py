"""The port's preprocess and crop ops against ``vtd_tpu.ops``.

Tolerances: ``yuv420_to_bgr`` exact; ``preprocess_frames`` within 1e-5
after normalisation on the shape the main path ships (640x360 -> 640^2);
crops within 1e-5 (float32 sums in another order); ``iou_matrix`` within
1e-6, ``nms`` keep masks and ``temporal_dedup`` tracks equal.
"""
import cv2
import numpy as np
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
