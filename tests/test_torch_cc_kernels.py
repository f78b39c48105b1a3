"""The port's connected-components round against the Pallas kernel.

``segmented_cc_round_plain`` (vtd_tpu_torch) is held against
``vtd_tpu.ops.pallas_kernels.segmented_cc_round(interpret=True)`` on the
same numpy maps: exact integer equality. The CUDA kernel itself runs
only on a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cc_kernels.py`` (no JAX or cv2 needed there).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SIZE = 48


def _banner(angle, length=44, width=3):
    """Thin filled rectangle through the map centre at ``angle`` degrees."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] - (SIZE - 1) / 2
    t = np.deg2rad(angle)
    u = xx * np.cos(t) + yy * np.sin(t)
    v = -xx * np.sin(t) + yy * np.cos(t)
    return (np.abs(u) <= length / 2) & (np.abs(v) <= width / 2)


def _maps():
    rng = np.random.default_rng(3)
    out = [(f"noise{p}", rng.random((SIZE, SIZE)) < p) for p in (0.3, 0.5, 0.7)]
    stairs = np.zeros((SIZE, SIZE), bool)
    for i in range(0, SIZE - 2, 2):
        stairs[i:i + 2, i:i + 2] = True
    out.append(("staircase", stairs))
    out += [(f"banner{ang}", _banner(ang)) for ang in (-45, 30)]
    return out


MAPS = _maps()


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("name,m", MAPS, ids=[n for n, _ in MAPS])
def test_plain_round_matches_pallas_interpret(name, m, diag):
    import jax.numpy as jnp

    from vtd_tpu.ops.pallas_kernels import segmented_cc_round as ref_round
    from vtd_tpu_torch.ops.cc_kernels import segmented_cc_round_plain

    rng = np.random.default_rng(len(name))
    for labels in (
        np.arange(SIZE * SIZE, dtype=np.int32).reshape(SIZE, SIZE),
        rng.permutation(SIZE * SIZE).astype(np.int32).reshape(SIZE, SIZE),
    ):
        want = np.asarray(
            ref_round(jnp.asarray(m), jnp.asarray(labels), diag=diag,
                      interpret=True)
        )
        got = segmented_cc_round_plain(
            torch.from_numpy(m)[None], torch.from_numpy(labels)[None], diag
        )[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    from vtd_tpu_torch.ops.cc_kernels import (
        segmented_cc_round, segmented_cc_round_plain,
    )

    m = torch.from_numpy(MAPS[1][1])[None].repeat(2, 1, 1)
    lbl = torch.arange(SIZE * SIZE, dtype=torch.int32).reshape(1, SIZE, SIZE)
    lbl = lbl.repeat(2, 1, 1)
    before = segmented_cc_round.launches
    got = segmented_cc_round(m, lbl, diag=True)
    assert torch.equal(got, segmented_cc_round_plain(m, lbl, diag=True))
    assert segmented_cc_round.launches == before


@pytest.mark.parametrize(
    "binary,labels,exc",
    [
        (torch.zeros(4, 4, dtype=torch.bool),
         torch.zeros(4, 4, dtype=torch.int32), ValueError),
        (torch.zeros(1, 4, 4, dtype=torch.bool),
         torch.zeros(1, 4, 5, dtype=torch.int32), ValueError),
        (torch.zeros(1, 4, 4, dtype=torch.uint8),
         torch.zeros(1, 4, 4, dtype=torch.int32), TypeError),
        (torch.zeros(1, 4, 4, dtype=torch.bool),
         torch.zeros(1, 4, 4, dtype=torch.int64), TypeError),
    ],
)
def test_wrapper_rejects_bad_inputs(binary, labels, exc):
    from vtd_tpu_torch.ops.cc_kernels import segmented_cc_round

    with pytest.raises(exc):
        segmented_cc_round(binary, labels)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [False, True])
def test_cuda_kernel_matches_plain_version(cuda_device, diag):
    from vtd_tpu_torch.ops.cc_kernels import (
        segmented_cc_round, segmented_cc_round_plain,
    )

    rng = np.random.default_rng(0)
    maps = np.stack([m for _, m in MAPS])
    fg = torch.from_numpy(maps).to(cuda_device)
    lbl = torch.from_numpy(
        np.stack([rng.permutation(SIZE * SIZE).astype(np.int32)
                  .reshape(SIZE, SIZE) for _ in MAPS])
    ).to(cuda_device)
    before = segmented_cc_round.launches
    got = segmented_cc_round(fg, lbl, diag)
    assert segmented_cc_round.launches == before + 1
    assert torch.equal(got, segmented_cc_round_plain(fg, lbl, diag))
