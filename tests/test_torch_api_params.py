"""Reference parameters the port takes under the reference's names:
``shard_variables(variables, mesh, min_size)`` and the per-map ops'
first parameters (``prob_map``, ``image``), passed by keyword as a
reference caller may pass them."""
import numpy as np
import torch

torch.set_num_threads(2)


def test_shard_variables_takes_mesh_and_min_size():
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.parallel.sharding import shard_variables
    from vtd_tpu_torch.parallel.tensor_parallel import n_split
    from vtd_tpu_torch.runtime import TextRecognizer

    rec = TextRecognizer(use_transformer=False, device="cpu")
    mesh = make_mesh(n_data=1, n_model=2, device="cpu")
    (default,) = shard_variables(rec, mesh=mesh)
    (wide,) = shard_variables(rec, mesh, min_size=1 << 20)
    assert n_split(default.crnn) > 0
    assert n_split(wide.crnn) == 0  # no layer is that wide
    (same,) = shard_variables(rec, make_mesh(n_data=1, device="cpu"))
    assert same is rec


def test_per_map_ops_take_the_reference_keywords():
    from vtd_tpu_torch.ops.crop import crop_and_resize_boxes_mm
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess

    prob = np.zeros((64, 64), np.float32)
    prob[10:30, 8:50] = 0.9
    post = db_postprocess(prob_map=torch.from_numpy(prob), bin_thresh=0.5,
                          min_area=10.0)
    assert post["valid"].shape == (64,) and int(post["valid"].sum()) == 1
    img = torch.from_numpy(
        np.random.default_rng(0).integers(0, 255, (64, 64, 3), np.uint8))
    crops = crop_and_resize_boxes_mm(image=img, boxes=post["boxes"],
                                     valid=post["valid"])
    assert crops.shape == (64, 32, 128, 3)
    assert torch.equal(crops, crop_and_resize_boxes_mm(img, post["boxes"],
                                                       post["valid"]))
