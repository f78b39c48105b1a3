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
        (torch.zeros(4, dtype=torch.bool),  # one map is [H, W]
         torch.zeros(4, dtype=torch.int32), 8, ValueError),
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


PLAN_SIZES = (1, 2, 17, 31, 32, 33, 50, 70, 320, 1000, 2048)
SMEM_LIMIT = 232448  # shared memory one block can have on sm_90


def _tiles(first_of, size, grid, n):
    """How often each of n cells lies in a block's tile; every block must
    hold one."""
    count = np.zeros(n, int)
    for g in range(grid):
        a, b = first_of(g), min(first_of(g) + size, n)
        assert b > a, "a block with no cell"
        count[a:b] += 1
    return count


@pytest.mark.parametrize("iters", [1, 4, 8, 64, 65, 200])
@pytest.mark.parametrize("h", PLAN_SIZES)
def test_sweep_plan_covers_each_cell_once(h, iters):
    """Shared bytes within a block's limit, every cell in exactly one
    tile, the launches' sweeps summing to ``iters``, and each launch's
    halo at least its sweeps (the centre is right after them)."""
    from vtd_tpu_torch.ops.cc_kernels import sweep_plan

    for w in PLAN_SIZES:
        p = sweep_plan(h, w, iters)
        assert 0 < p.smem <= SMEM_LIMIT
        assert p.tile >= 1 and p.tile + 2 * p.halo == 96
        for n, grid in ((h, p.grid_rows), (w, p.grid_cols)):
            count = _tiles(lambda g: g * p.tile, p.tile, grid, n)
            assert (count == 1).all(), (h, w, iters, p)
        if p.vec:  # 4-cell groups wholly in or out of the map and tile
            assert w % 4 == 0 and p.halo % 4 == 0 and p.tile % 4 == 0
        assert p.vec == (w % 4 == 0)
        assert len(p.sweeps) == p.launches == -(-iters // 8)
        assert sum(p.sweeps) == iters
        assert all(1 <= s <= p.halo for s in p.sweeps), p


def test_sweep_plan_fields_are_the_kernels_struct():
    """The wrapper hands the plan to the C function as ints in field
    order: the order must be that of ``struct Plan`` in the source."""
    import re
    from pathlib import Path

    from vtd_tpu_torch.ops.cc_kernels import SweepPlan

    src = (Path(__file__).resolve().parents[1] / "vtd_tpu_torch" / "csrc"
           / "neighbor_min_sweeps.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"\w+", body.replace("int", " "))
    assert tuple(names) == SweepPlan._fields


def _tiled_model(fg, labels, plan, rng):
    """The kernel's schedule in numpy: each launch loads every block's
    96x96 window (background and cells beyond the map hold 2^30), runs
    its sweeps on the whole window with garbage beyond the window's
    border, and stores the tile's foreground cells; background cells keep
    their labels. Launches chain, as the wrapper's split does."""
    big = 2 ** 30
    b, h, w = fg.shape
    win = plan.tile + 2 * plan.halo
    cur = labels.copy()
    for sweeps in plan.sweeps:
        nxt = cur.copy()
        for tr in range(plan.grid_rows):
            for tc in range(plan.grid_cols):
                r0, c0 = tr * plan.tile - plan.halo, tc * plan.tile - plan.halo
                on = np.zeros((b, win, win), bool)
                val = np.full((b, win, win), big, np.int64)
                rs, re_ = max(r0, 0), min(r0 + win, h)
                cs, ce = max(c0, 0), min(c0 + win, w)
                on[:, rs - r0:re_ - r0, cs - c0:ce - c0] = fg[:, rs:re_, cs:ce]
                val[:, rs - r0:re_ - r0, cs - c0:ce - c0] = cur[:, rs:re_, cs:ce]
                val[~on] = big
                for _ in range(sweeps):
                    pad = rng.integers(0, big, (b, win + 2, win + 2))
                    pad[:, 1:-1, 1:-1] = val
                    m = pad[:, :-2, 1:-1]
                    for dr in range(3):
                        for dc in range(3):
                            m = np.minimum(m, pad[:, dr:dr + win, dc:dc + win])
                    val = np.where(on, m, big)
                cen = np.s_[:, plan.halo:plan.halo + plan.tile,
                            plan.halo:plan.halo + plan.tile]
                tr0, tc0 = tr * plan.tile, tc * plan.tile
                th = min(plan.tile, h - tr0)
                tw = min(plan.tile, w - tc0)
                o = nxt[:, tr0:tr0 + th, tc0:tc0 + tw]
                f = fg[:, tr0:tr0 + th, tc0:tc0 + tw]
                o[f] = val[cen][:, :th, :tw][f]
        cur = nxt
    return cur


@pytest.mark.parametrize(
    "shape,iters",
    [((2, 50, 70), 8), ((2, 50, 70), 65), ((1, 7, 200), 9), ((1, 1, 1), 3),
     ((1, 1, 300), 8), ((1, 300, 1), 8), ((1, 170, 90), 4), ((1, 5, 5), 20)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v),
)
def test_tiled_schedule_of_the_plan_equals_plain_version(shape, iters):
    """The plan's tiling, halo and split of ``iters``, run as the kernel
    runs them (with random values beyond each window), give the plain
    version's labels: edges of the map, partial tiles, a halo larger than
    the map, several launches."""
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps_plain, sweep_plan,
    )

    rng = np.random.default_rng(sum(shape) + iters)
    b, h, w = shape
    fg = rng.random(shape) < 0.6
    fg[0, h // 2, :] = True  # one long component
    labels = rng.permutation(b * h * w).astype(np.int32).reshape(shape)
    want = neighbor_min_sweeps_plain(
        torch.from_numpy(fg), torch.from_numpy(labels), iters).numpy()
    got = _tiled_model(fg, labels, sweep_plan(h, w, iters), rng)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iters", [65, 200])
def test_wrapper_takes_any_iters_on_cpu(iters):
    """No limit on ``iters``: the reference takes any, and sweeps
    compose."""
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, neighbor_min_sweeps_plain,
    )

    h, w = 50, 70
    fg = torch.from_numpy(np.stack([m for _, m in _maps(h, w)]))
    lbl = torch.from_numpy(np.stack(_labels(h, w, iters)[1:] * len(fg)))
    got = neighbor_min_sweeps(fg, lbl, iters=iters)
    assert torch.equal(got, neighbor_min_sweeps_plain(fg, lbl, iters))
    half = neighbor_min_sweeps(fg, lbl, iters=iters // 2)
    assert torch.equal(
        got, neighbor_min_sweeps(fg, half, iters=iters - iters // 2))


def test_wrapper_returns_empty_batch_on_cpu():
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps

    for shape in ((0, 5, 5), (2, 0, 5), (2, 5, 0)):
        got = neighbor_min_sweeps(
            torch.zeros(shape, dtype=torch.bool),
            torch.zeros(shape, dtype=torch.int32))
        assert got.shape == shape and got.dtype == torch.int32


@pytest.mark.parametrize("shape", [(65536, 4, 4), (1, 65536 * 80, 1),
                                   (2, 40000, 30000)],
                         ids=["batch", "tall", "cells"])
def test_wrapper_refuses_maps_past_the_grid(shape):
    """Past the kernel's grid or int32 labels the wrapper raises before
    it allocates or launches: checked on meta tensors, which no kernel
    can touch."""
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps

    binary = torch.empty(shape, dtype=torch.bool, device="meta")
    labels = torch.empty(shape, dtype=torch.int32, device="meta")
    before = neighbor_min_sweeps.launches, neighbor_min_sweeps.cuda_launches
    with pytest.raises(ValueError, match="grid"):
        neighbor_min_sweeps(binary, labels, iters=8)
    assert (neighbor_min_sweeps.launches,
            neighbor_min_sweeps.cuda_launches) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _check_on_card(device, fg, lbl, iters):
    """The kernel against the plain version on the card, with the wrapper
    call and its CUDA launches counted."""
    from vtd_tpu_torch.ops.cc_kernels import (
        neighbor_min_sweeps, neighbor_min_sweeps_plain,
    )

    fg, lbl = fg.to(device), lbl.to(device)
    before = neighbor_min_sweeps.launches, neighbor_min_sweeps.cuda_launches
    got = neighbor_min_sweeps(fg, lbl, iters)
    assert (neighbor_min_sweeps.launches,
            neighbor_min_sweeps.cuda_launches) == (
        before[0] + 1, before[1] + -(-iters // 8))
    assert torch.equal(got, neighbor_min_sweeps_plain(fg, lbl, iters))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 4, 8])
def test_cuda_kernel_matches_plain_version(cuda_device, iters):
    for h, w in SHAPES:
        maps = _maps(h, w)
        fg = torch.from_numpy(np.stack([m for _, m in maps]))
        rng = np.random.default_rng(iters)
        lbl = torch.from_numpy(
            np.stack([rng.permutation(h * w).astype(np.int32).reshape(h, w)
                      for _ in maps])
        )
        _check_on_card(cuda_device, fg, lbl, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [65, 200])
def test_cuda_kernel_splits_large_iters(cuda_device, iters):
    """Past 8 sweeps the wrapper splits ``iters`` over several launches of
    the kernel: the labels one launch of all sweeps would give."""
    fg = torch.ones(1, 40, 40, dtype=torch.bool)
    fg[0, 20, 1:] = False  # a wall with one gap: a long way round
    lbl = torch.arange(1600, dtype=torch.int32).flip(0).reshape(1, 40, 40)
    _check_on_card(cuda_device, fg, lbl, iters)
    rng = np.random.default_rng(iters)
    fg = torch.from_numpy(rng.random((3, 150, 130)) < 0.6)
    lbl = torch.from_numpy(
        rng.permutation(3 * 150 * 130).astype(np.int32).reshape(3, 150, 130))
    _check_on_card(cuda_device, fg, lbl, iters)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,iters",
    [((1, 320, 320), 8), ((1, 1, 1), 8), ((1, 1, 300), 8), ((1, 300, 1), 8),
     ((2, 5, 9), 12), ((1, 7, 1000), 8), ((3, 161, 83), 8), ((2, 97, 250), 3)],
    ids=["B=1", "1x1", "1x300", "300x1", "iters>H", "7x1000",
         "161x83 (no multiple of the tile)", "97x250 iters=3"],
)
def test_cuda_kernel_edges_of_the_plan(cuda_device, shape, iters):
    rng = np.random.default_rng(sum(shape))
    fg = torch.from_numpy(rng.random(shape) < 0.7)
    n = int(np.prod(shape))
    lbl = torch.from_numpy(
        rng.permutation(n).astype(np.int32).reshape(shape))
    _check_on_card(cuda_device, fg, lbl, iters)


@pytest.mark.cuda
def test_cuda_kernel_returns_empty_batch(cuda_device):
    from vtd_tpu_torch.ops.cc_kernels import neighbor_min_sweeps

    before = neighbor_min_sweeps.launches, neighbor_min_sweeps.cuda_launches
    for shape in ((0, 320, 320), (2, 0, 5), (2, 5, 0)):
        got = neighbor_min_sweeps(
            torch.zeros(shape, dtype=torch.bool, device=cuda_device),
            torch.zeros(shape, dtype=torch.int32, device=cuda_device))
        assert got.shape == shape and got.device.type == "cuda"
    assert (neighbor_min_sweeps.launches,
            neighbor_min_sweeps.cuda_launches) == before
