"""The port's preprocess and crop ops against ``vtd_tpu.ops``.

Tolerances: ``yuv420_to_bgr`` exact; ``preprocess_frames`` within 1e-5
after normalisation on the shape the main path ships (640x360 -> 640^2);
crops within 1e-5 (float32 sums in another order).
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
