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
    before = segmented_cc_round.launches, segmented_cc_round.cuda_launches
    got = segmented_cc_round(m, lbl, diag=True)
    assert torch.equal(got, segmented_cc_round_plain(m, lbl, diag=True))
    assert (segmented_cc_round.launches,
            segmented_cc_round.cuda_launches) == before


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


PLAN_SIZES = (1, 2, 31, 32, 33, 50, 70, 320, 321, 640, 1024, 2048)
SMEM_LIMIT = 232448  # dynamic shared memory one block can have on sm_90


@pytest.mark.parametrize("h", PLAN_SIZES)
def test_plan_fits_shared_memory(h):
    from vtd_tpu_torch.ops.cc_kernels import segmented_plan

    for w in PLAN_SIZES:
        p = segmented_plan(h, w)
        for size in (p.rows, p.cols, p.diags):
            assert size >= 1 and size & (size - 1) == 0
        assert p.diags >= 2  # two runs of diags/2 a block
        for smem in (p.smem_rows, p.smem_cols, p.smem_diag):
            assert 0 < smem <= SMEM_LIMIT, (h, w, p)


def _covered(first, size, grid, lo, hi, runs=1):
    """How often each line lo..hi-1 lies in a block's strip, and whether
    every block holds at least one line. A block takes ``runs`` runs of
    ``size`` lines: runs g, g + grid, ...; run i covers
    [first + i*size, first + (i+1)*size)."""
    count = np.zeros(hi - lo, int)
    for g in range(grid):
        held = 0
        for i in range(g, g + runs * grid, grid):
            a = max(first + i * size, lo)
            b = min(first + (i + 1) * size, hi)
            if b > a:
                count[a - lo:b - lo] += 1
                held += b - a
        assert held > 0, "a block with no line"
    return count


@pytest.mark.parametrize("h", PLAN_SIZES)
def test_plan_strips_cover_each_line_once(h):
    """Rows, columns, main diagonals (c - r) and anti-diagonals (c + r):
    each in exactly one block's strip, from the offsets the kernel uses
    (a diagonal block takes two runs of diags/2 diagonals)."""
    from vtd_tpu_torch.ops.cc_kernels import segmented_plan

    for w in PLAN_SIZES:
        p = segmented_plan(h, w)
        half = p.diags // 2
        for first, size, grid, lo, hi, runs in (
            (0, p.rows, p.grid_rows, 0, h, 1),
            (0, p.cols, p.grid_cols, 0, w, 1),
            (p.main_first, half, p.grid_diag, -(h - 1), w, 2),
            (p.anti_first, half, p.grid_diag, 0, h + w - 1, 2),
        ):
            count = _covered(first, size, grid, lo, hi, runs)
            assert (count == 1).all(), (h, w)


def test_plan_fields_are_the_kernels_struct():
    """The wrapper hands the plan to the C function as ints in field order:
    the order must be that of ``struct Plan`` in the source."""
    import re
    from pathlib import Path

    from vtd_tpu_torch.ops.cc_kernels import SegmentedPlan

    src = (Path(__file__).resolve().parents[1] / "vtd_tpu_torch" / "csrc"
           / "segmented_cc.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"\w+", body.replace("int", " "))
    assert tuple(names) == SegmentedPlan._fields


@pytest.mark.parametrize("shape", [(1, 1, 9000), (1, 12000, 1),
                                   (2, 12000, 9000), (65536, 4, 4)],
                         ids=["wide", "tall", "both", "batch"])
def test_wrapper_refuses_maps_past_the_plan(shape):
    """Past what a block's shared memory (or the grid) holds, the wrapper
    raises before it allocates or launches: checked on meta tensors, which
    no kernel can touch."""
    from vtd_tpu_torch.ops.cc_kernels import segmented_cc_round, segmented_plan

    binary = torch.empty(shape, dtype=torch.bool, device="meta")
    labels = torch.empty(shape, dtype=torch.int32, device="meta")
    before = segmented_cc_round.launches
    with pytest.raises(ValueError, match="232448|grid"):
        segmented_cc_round(binary, labels, diag=True)
    assert segmented_cc_round.launches == before
    if shape[0] == 1:
        with pytest.raises(ValueError, match="232448"):
            segmented_plan(*shape[1:])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("shape", [(SIZE, SIZE), (37, 45)],
                         ids=["48x48", "37x45"])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, diag):
    """On the card, label for label; 37x45 is no multiple of any strip."""
    from vtd_tpu_torch.ops.cc_kernels import (
        segmented_cc_round, segmented_cc_round_plain,
    )

    rng = np.random.default_rng(0)
    h, w = shape
    maps = np.stack([m[:h, :w] for _, m in MAPS])
    if shape != (SIZE, SIZE):
        maps = np.concatenate([maps, rng.random((3, h, w)) < 0.6])
    fg = torch.from_numpy(np.ascontiguousarray(maps)).to(cuda_device)
    lbl = torch.from_numpy(
        np.stack([rng.permutation(h * w).astype(np.int32).reshape(h, w)
                  for _ in maps])
    ).to(cuda_device)
    before = segmented_cc_round.launches, segmented_cc_round.cuda_launches
    got = segmented_cc_round(fg, lbl, diag)
    assert (segmented_cc_round.launches,
            segmented_cc_round.cuda_launches) == (
        before[0] + 1, before[1] + (4 if diag else 2))
    assert torch.equal(got, segmented_cc_round_plain(fg, lbl, diag))
