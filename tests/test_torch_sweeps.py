"""The port's 8-neighbour minimum sweeps and dense labelling path against
``vtd_tpu``.

``neighbor_min_sweeps_plain`` (vtd_tpu_torch) is held against
``vtd_tpu.ops.pallas_kernels.neighbor_min_sweeps(interpret=True)`` and the
dense backend of ``connected_components`` against the reference's
``backend="xla"``, on the same numpy maps: exact integer equality. The
CUDA kernel itself runs only on a card: ``python -m pytest --noconftest
-m cuda tests/test_torch_sweeps.py`` (no JAX or cv2 needed there).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SHAPES = [(48, 48), (50, 70), (33, 17)]


def _banner(h, w, angle, width=3):
    """Thin filled rectangle through the map centre at ``angle`` degrees."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yy -= (h - 1) / 2
    xx -= (w - 1) / 2
    t = np.deg2rad(angle)
    u = xx * np.cos(t) + yy * np.sin(t)
    v = -xx * np.sin(t) + yy * np.cos(t)
    return (np.abs(u) <= 0.45 * max(h, w)) & (np.abs(v) <= width / 2)


def _maps(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    out = [(f"noise{p}", rng.random((h, w)) < p) for p in (0.3, 0.5, 0.7)]
    stairs = np.zeros((h, w), bool)
    for i in range(0, min(h, w) - 2, 2):
        stairs[i:i + 2, i:i + 2] = True
    out.append(("staircase", stairs))
    out += [(f"banner{a}", _banner(h, w, a)) for a in (-45, 30)]
    out.append(("empty", np.zeros((h, w), bool)))
    out.append(("full", np.ones((h, w), bool)))
    frame = np.zeros((h, w), bool)
    frame[0, :] = frame[-1, :] = frame[:, 0] = frame[:, -1] = True
    out.append(("border", frame))
    return out


def _labels(h, w, seed):
    rng = np.random.default_rng(seed)
    return [
        np.arange(h * w, dtype=np.int32).reshape(h, w),
        rng.permutation(h * w).astype(np.int32).reshape(h, w),
    ]


@pytest.mark.parametrize("iters", [1, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_sweeps_match_pallas_interpret(shape, iters):
    import jax.numpy as jnp

    from vtd_tpu.ops.pallas_kernels import neighbor_min_sweeps as ref_sweeps
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps_plain

    h, w = shape
    for name, m in _maps(h, w):
        for labels in _labels(h, w, len(name)):
            want = np.asarray(
                ref_sweeps(jnp.asarray(m), jnp.asarray(labels), iters=iters,
                           interpret=True)
            )
            got = neighbor_min_sweeps_plain(
                torch.from_numpy(m)[None], torch.from_numpy(labels)[None],
                iters,
            )[0].numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("backend", ["pallas", "pallas-auto", "xla"])
@pytest.mark.parametrize(
    "dense_iters,jump_rounds", [(8, 4), (2, 3)], ids=["8x4", "2x3"]
)
def test_dense_connected_components_match_reference(
    backend, dense_iters, jump_rounds
):
    """Label for label what the reference's dense schedule gives, also
    where that schedule stops short of the exact labelling (2x3 on a long
    banner)."""
    import jax.numpy as jnp

    from vtd_tpu.ops.db_postprocess import connected_components as ref_cc
    from vtd_tpu_torch.ops.db_postprocess import connected_components

    h, w = 50, 70
    maps = _maps(h, w)
    stack = np.stack([m for _, m in maps])
    got = connected_components(
        torch.from_numpy(stack), dense_iters=dense_iters,
        jump_rounds=jump_rounds, backend=backend,
    ).numpy()
    assert got.shape == (len(maps), h * w) and got.dtype == np.int32
    for i, (name, m) in enumerate(maps):
        want = np.asarray(
            ref_cc(jnp.asarray(m), dense_iters=dense_iters,
                   jump_rounds=jump_rounds, backend="xla")
        )
        np.testing.assert_array_equal(got[i], want, err_msg=name)


def test_dense_backend_reaches_exact_labels_on_small_blobs():
    """Within its reach the dense schedule is the exact labelling, equal
    to the scan backend's."""
    from vtd_tpu_torch.ops.db_postprocess import connected_components

    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.random((3, 40, 40)) < 0.45)
    assert torch.equal(
        connected_components(m, backend="pallas"),
        connected_components(m, backend="scan", exact=True),
    )


def test_connected_components_rejects_unknown_backend():
    from vtd_tpu_torch.ops.db_postprocess import connected_components

    with pytest.raises(ValueError, match="unknown backend"):
        connected_components(
            torch.zeros(1, 4, 4, dtype=torch.bool), backend="triton"
        )


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, neighbor_min_sweeps_plain,
    )

    h, w = 50, 70
    m = torch.from_numpy(_maps(h, w)[1][1])[None].repeat(2, 1, 1)
    lbl = torch.arange(h * w, dtype=torch.int32).reshape(1, h, w)
    lbl = lbl.repeat(2, 1, 1)
    before = neighbor_min_sweeps.launches
    got = neighbor_min_sweeps(m, lbl, iters=3)
    assert torch.equal(got, neighbor_min_sweeps_plain(m, lbl, 3))
    assert neighbor_min_sweeps.launches == before
    # background keeps its label, a foreground label never rises
    assert torch.equal(got[~m], lbl[~m])
    assert bool((got <= lbl).all())


@pytest.mark.parametrize(
    "binary,labels,iters,exc",
    [
        (torch.zeros(4, 4, dtype=torch.bool),
         torch.zeros(4, 4, dtype=torch.int32), 8, ValueError),
        (torch.zeros(1, 4, 4, dtype=torch.bool),
         torch.zeros(1, 4, 5, dtype=torch.int32), 8, ValueError),
        (torch.zeros(1, 4, 4, dtype=torch.uint8),
         torch.zeros(1, 4, 4, dtype=torch.int32), 8, TypeError),
        (torch.zeros(1, 4, 4, dtype=torch.bool),
         torch.zeros(1, 4, 4, dtype=torch.int64), 8, TypeError),
        (torch.zeros(1, 4, 4, dtype=torch.bool),
         torch.zeros(1, 4, 4, dtype=torch.int32), 0, ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(binary, labels, iters, exc):
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps

    with pytest.raises(exc):
        neighbor_min_sweeps(binary, labels, iters)


def test_shared_memory_need_grows_with_iters():
    from vtd_tpu_torch.ops.cc_kernels import _SMEM_LIMIT, sweep_smem_bytes

    assert sweep_smem_bytes(8) == 48 * 48 * 9
    assert sweep_smem_bytes(64) <= _SMEM_LIMIT < sweep_smem_bytes(65)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 4, 8])
def test_cuda_kernel_matches_plain_version(cuda_device, iters):
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, neighbor_min_sweeps_plain,
    )

    for h, w in SHAPES:
        maps = _maps(h, w)
        fg = torch.from_numpy(np.stack([m for _, m in maps])).to(cuda_device)
        rng = np.random.default_rng(iters)
        lbl = torch.from_numpy(
            np.stack([rng.permutation(h * w).astype(np.int32).reshape(h, w)
                      for _ in maps])
        ).to(cuda_device)
        before = neighbor_min_sweeps.launches
        got = neighbor_min_sweeps(fg, lbl, iters)
        assert neighbor_min_sweeps.launches == before + 1
        assert torch.equal(got, neighbor_min_sweeps_plain(fg, lbl, iters))


@pytest.mark.cuda
def test_cuda_kernel_refuses_iters_past_shared_memory(cuda_device):
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps

    fg = torch.ones(1, 40, 40, dtype=torch.bool, device=cuda_device)
    lbl = torch.arange(1600, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        neighbor_min_sweeps(fg, lbl.reshape(1, 40, 40), iters=65)
