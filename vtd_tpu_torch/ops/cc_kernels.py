"""Connected-components label propagation: CUDA kernels and plain twins.

``segmented_cc_round`` is the port of the TPU kernel
``vtd_tpu/ops/pallas_kernels.py:segmented_cc_round`` (kernel body
``_seg_round_kernel``). On a CUDA tensor it launches
``csrc/segmented_cc.cu`` (design and bound in the note there); on a CPU
tensor it runs ``segmented_cc_round_plain``, the same recurrence written
as the reference's shift-and-min ladders in plain PyTorch. Both give the
same labels, label for label.

``neighbor_min_sweeps`` is the port of the TPU kernel
``vtd_tpu/ops/pallas_kernels.py:neighbor_min_sweeps`` (kernel body
``_sweep_kernel``): ``iters`` Jacobi sweeps of the 8-neighbour minimum.
CUDA tensors launch ``csrc/neighbor_min_sweeps.cu`` (design and bound in
the note there; launch plan ``sweep_plan``); CPU tensors run
``neighbor_min_sweeps_plain``.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from .._build import kernel
from ._rank import one_or_batch

BIG = 2 ** 30  # label sentinel of the reference
_count_lock = threading.Lock()


def _shift(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """y[..., r, c] = x[..., r - dr, c - dc] where that cell exists, else
    ``fill`` (no wrap at the map edge, like the reference's masked
    rolls)."""
    h, w = x.shape[-2:]
    y = torch.full_like(x, fill)
    if abs(dr) >= h or abs(dc) >= w:
        return y
    y[..., max(dr, 0):h + min(dr, 0), max(dc, 0):w + min(dc, 0)] = x[
        ..., max(-dr, 0):h - max(dr, 0), max(-dc, 0):w - max(dc, 0)
    ]
    return y


def neighbour_min(masked: torch.Tensor) -> torch.Tensor:
    """min over the 8-neighbourhood and self, BIG beyond the edge."""
    horiz = torch.minimum(
        torch.minimum(_shift(masked, 0, 1, BIG), _shift(masked, 0, -1, BIG)),
        masked,
    )
    return torch.minimum(
        torch.minimum(_shift(horiz, 1, 0, BIG), _shift(horiz, -1, 0, BIG)),
        horiz,
    )


def _ladder(lf: torch.Tensor, fg: torch.Tensor, dr: int, dc: int, n: int):
    """Segmented reach-doubling ladder: prefix minimum of ``lf`` along
    direction (dr, dc) within each foreground run."""
    rf = fg
    d = 1
    while d < n:
        lsh = _shift(lf, dr * d, dc * d, BIG)
        rsh = _shift(rf, dr * d, dc * d, False)
        lf = torch.where(rf, torch.minimum(lf, lsh), lf)
        rf = rf & rsh
        d *= 2
    return lf


def segmented_cc_round_plain(
    binary: torch.Tensor, labels: torch.Tensor, diag: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of one round: binary [B,H,W] bool, labels
    [B,H,W] int32 -> [B,H,W] int32 (``pallas_kernels.py:104-170``)."""
    fg = binary
    h, w = fg.shape[-2:]

    def min8(m):
        out = neighbour_min(torch.where(fg, m, BIG))
        return torch.where(fg, torch.minimum(m, out), m)

    def axis_pass(lbl, dr, dc, n):
        seed = torch.where(fg, lbl, BIG)
        for sgn in (1, -1):
            lf = _ladder(seed, fg, sgn * dr, sgn * dc, n)
            lbl = torch.where(fg, torch.minimum(lbl, lf), lbl)
        return lbl

    lbl = min8(labels)
    lbl = axis_pass(lbl, 0, 1, w)  # along rows
    lbl = min8(lbl)
    lbl = axis_pass(lbl, 1, 0, h)  # along columns
    if diag:
        for sr, sc in ((1, 1), (-1, -1), (1, -1), (-1, 1)):
            lf = _ladder(torch.where(fg, lbl, BIG), fg, sr, sc, min(h, w))
            lbl = torch.where(fg, torch.minimum(lbl, lf), lbl)
    return lbl


def _check(binary: torch.Tensor, labels: torch.Tensor) -> None:
    if binary.dim() != 3 or labels.shape != binary.shape:
        raise ValueError(
            f"expected binary and labels of one [H,W] or [B,H,W] shape, got "
            f"{tuple(binary.shape)} and {tuple(labels.shape)}"
        )
    if binary.dtype != torch.bool or labels.dtype != torch.int32:
        raise TypeError(
            f"expected bool binary and int32 labels, got {binary.dtype} "
            f"and {labels.dtype}"
        )
    if binary.device != labels.device:
        raise ValueError("binary and labels are on different devices")


_SMEM_LIMIT = 232448  # dynamic shared memory one block can have on sm_90
_MAX_GRID_Y = 65535  # the map index is blockIdx.y


def _odd(n: int) -> int:
    return n | 1


def _mask_pitch(n: int) -> int:
    """Bytes per row of a strip's mask: an odd number of words, so that a
    warp reading one column of 32 rows hits 32 banks."""
    return _odd(-(-n // 4)) * 4


def _strip_smem(lines: int, n: int) -> int:
    """K1 and K2: masked and working labels of ``lines`` lines of ``n``
    cells plus two halo lines, and their mask, each with 3 cells of slack
    for the 16-byte phase (K1 takes rows of W cells, K2 columns of H)."""
    cells = (lines + 2) * n + 3
    return 8 * (-(-cells // 4) * 4) + -(-cells // 16) * 16


def _diag_smem(d: int, h: int) -> int:
    """K3/K4: two runs of d/2 diagonals sheared into columns, all H rows
    each, and their mask."""
    return 2 * h * (4 * _odd(d // 2) + _mask_pitch(d // 2))


def _pick(cap: int, smem_of, least: int = 1) -> int | None:
    """The largest power of two in [least, cap] whose strip fits a block's
    shared memory (``cap`` keeps every warp of a block on a line)."""
    size = cap
    while size >= least:
        if smem_of(size) <= _SMEM_LIMIT:
            return size
        size //= 2
    return None


class SegmentedPlan(NamedTuple):
    """Launch plan of one ``segmented_cc_round`` on [B, H, W] maps: strip
    sizes, blocks per map and dynamic shared bytes of each phase, and the
    first diagonal of each kind (main diagonals are c - r, anti-diagonals
    c + r). Block g of the row (column) phase covers rows (columns)
    [g*size, (g+1)*size). The diagonals of a kind form runs of diags/2,
    run i covering [first + i*diags/2, first + (i+1)*diags/2); block g of a
    diagonal phase takes runs g and g + grid_diag. The fields are the C
    ``Plan`` struct of ``csrc/segmented_cc.cu``, in order."""

    rows: int
    cols: int
    diags: int
    grid_rows: int
    grid_cols: int
    grid_diag: int
    smem_rows: int
    smem_cols: int
    smem_diag: int
    main_first: int
    anti_first: int


@functools.lru_cache(maxsize=64)
def _plan(h: int, w: int):
    if h < 1 or w < 1:
        raise ValueError(f"segmented_cc_round needs H, W >= 1, got {h}x{w}")
    r = _pick(min(8, _pow2_floor(h)), lambda s: _strip_smem(s, w))
    c = _pick(min(8, _pow2_floor(w)), lambda s: _strip_smem(s, h))
    d = _pick(max(2, min(16, _pow2_floor(h + w - 1))),
              lambda s: _diag_smem(s, h), least=2)
    for what, size in (("a row", r), ("a column", c), ("a diagonal", d)):
        if size is None:
            raise ValueError(
                f"segmented_cc_round: {what} strip of a {h}x{w} map needs "
                f"more than the {_SMEM_LIMIT} B of shared memory a block "
                f"can have (rows: {_strip_smem(1, w)} B, columns: "
                f"{_strip_smem(1, h)} B, diagonals: {_diag_smem(2, h)} B)"
            )
    runs = -(-(h + w - 1) // (d // 2))  # of d/2 diagonals, two a block
    plan = SegmentedPlan(
        r, c, d, -(-h // r), -(-w // c), -(-runs // 2),
        _strip_smem(r, w), _strip_smem(c, h), _diag_smem(d, h), -(h - 1), 0,
    )
    return plan, (ctypes.c_int * len(plan))(*plan)


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def segmented_plan(h: int, w: int) -> SegmentedPlan:
    """The launch plan for [*, h, w] maps; ``ValueError`` past the shared
    memory a block can have."""
    return _plan(int(h), int(w))[0]


_round_launch = kernel(
    "segmented_cc", "vtd_segmented_cc_round",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.POINTER(ctypes.c_int)],
)


@one_or_batch("H, W", "binary", "labels")
def segmented_cc_round(
    binary: torch.Tensor, labels: torch.Tensor, diag: bool = False
) -> torch.Tensor:
    """One segmented-propagation round over one map or a batch of maps.

    binary [H,W] or [B,H,W] bool, labels of the same shape int32 -> new
    labels of that shape, int32 (one map, as the reference's kernel takes
    it, runs as a batch of one); ``diag`` adds the diagonal ladders.
    CUDA tensors launch the
    kernel (contiguous inputs required; 2 kernels a round, 4 with
    ``diag``); CPU tensors take the plain twin. Off the CPU, maps whose
    strips do not fit a block's shared memory raise ``ValueError`` (see
    ``segmented_plan``) before anything is allocated or launched: a
    strip of one whole row or column must fit, so H and W are each at most
    8607 cells.
    """
    _check(binary, labels)
    dev = binary.device
    if dev.type == "cpu":
        return segmented_cc_round_plain(binary, labels, diag)
    b, h, w = binary.shape
    if b * h * w >= 2 ** 31 or b > _MAX_GRID_Y:
        raise ValueError(
            f"batch {b}x{h}x{w} too large for int32 labels or the kernel's "
            f"grid (B <= {_MAX_GRID_Y})"
        )
    if b * h * w == 0:
        return torch.empty_like(labels)
    _, plan = _plan(h, w)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (binary.is_contiguous() and labels.is_contiguous()):
        raise ValueError("segmented_cc_round needs contiguous tensors")
    # the transposed labels, then (from a 16-byte boundary) the transposed
    # mask, one byte a cell
    n = b * h * w
    scratch = torch.empty(-(-n // 4) * 5, dtype=torch.int32, device=dev)
    out = torch.empty_like(labels)
    _round_launch(dev.index, binary.data_ptr(), labels.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), b, h, w,
                  int(bool(diag)), plan)
    with _count_lock:
        segmented_cc_round.launches += 1
        segmented_cc_round.cuda_launches += 4 if diag else 2
    return out


# Wrapper calls that launched the CUDA kernels (CPU calls do not count),
# and the CUDA launches they made: 2 a round, 4 with ``diag``.
segmented_cc_round.launches = 0
segmented_cc_round.cuda_launches = 0


def neighbor_min_sweeps_plain(
    binary: torch.Tensor, labels: torch.Tensor, iters: int = 8
) -> torch.Tensor:
    """Plain PyTorch version of the sweeps: binary [B,H,W] bool, labels
    [B,H,W] int32 -> [B,H,W] int32 (``pallas_kernels.py:44-52``). Every
    sweep reads the labels the previous sweep left."""
    lbl = labels
    for _ in range(iters):
        m = neighbour_min(torch.where(binary, lbl, BIG))
        lbl = torch.where(binary, m, lbl)
    return lbl


# The sweeps kernel's geometry (csrc/neighbor_min_sweeps.cu): a block holds
# a 96x96 window in registers; it passes through shared memory (int32
# labels and a byte mask a cell) on its way in and out, beside each of its
# 8 warps' first and last row for two sweep parities.
_SWEEP_WIN = 96
_SWEEP_SMEM = _SWEEP_WIN * _SWEEP_WIN * 5 + 2 * 8 * 2 * _SWEEP_WIN * 4
# Most sweeps one launch runs: at halo h a window carries 96^2/(96-2h)^2 of
# its tile's work per sweep, 1.44x at 8 and 2.25x at 16, so a larger
# ``iters`` takes more launches rather than a wider halo.
_SWEEP_CAP = 8
_MAX_GRID_YZ = 65535  # tile rows are blockIdx.y, maps blockIdx.z


class SweepPlan(NamedTuple):
    """Launch plan of ``neighbor_min_sweeps`` on [B, H, W] maps: block
    (r, c) of map b owns output rows [r*tile, (r+1)*tile) and columns
    [c*tile, (c+1)*tile) and loads them with a halo of ``halo`` cells;
    launch k runs ``sweeps[k]`` = min(halo, iters - k*halo) sweeps. With
    ``vec`` (W a multiple of 4, and then the halo too) every 4-cell group
    of a window row lies wholly in or out of the map and of the tile, and
    the kernel moves it with one 16-byte access. The fields are the C
    ``Plan`` struct of ``csrc/neighbor_min_sweeps.cu``, in order."""

    tile: int
    halo: int
    grid_cols: int
    grid_rows: int
    launches: int
    smem: int
    iters: int
    vec: int

    @property
    def sweeps(self) -> tuple:
        return tuple(min(self.halo, self.iters - k * self.halo)
                     for k in range(self.launches))


@functools.lru_cache(maxsize=64)
def _sweep_plan(h: int, w: int, iters: int):
    if h < 1 or w < 1:
        raise ValueError(f"neighbor_min_sweeps needs H, W >= 1, got {h}x{w}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    launches = -(-iters // _SWEEP_CAP)
    halo = -(-iters // launches)  # the least that holds, <= _SWEEP_CAP
    vec = int(w % 4 == 0)
    if vec:  # a multiple of 4 (as _SWEEP_CAP is), so is the tile
        halo = -(-halo // 4) * 4
    tile = _SWEEP_WIN - 2 * halo
    plan = SweepPlan(tile, halo, -(-w // tile), -(-h // tile), launches,
                     _SWEEP_SMEM, iters, vec)
    return plan, (ctypes.c_int * len(plan))(*plan)


def sweep_plan(h: int, w: int, iters: int) -> SweepPlan:
    """The launch plan of ``iters`` sweeps over [*, h, w] maps."""
    return _sweep_plan(int(h), int(w), int(iters))[0]


_sweeps_launch = kernel(
    "neighbor_min_sweeps", "vtd_neighbor_min_sweeps",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.POINTER(ctypes.c_int)],
)


@one_or_batch("H, W", "binary", "labels")
def neighbor_min_sweeps(
    binary: torch.Tensor, labels: torch.Tensor, iters: int = 8
) -> torch.Tensor:
    """``iters`` 8-neighbour minimum sweeps over one map or a batch.

    binary [H,W] or [B,H,W] bool, labels of the same shape int32 -> new
    labels of that shape, int32 (one map runs as a batch of one): foreground cells take the minimum label of their foreground
    3x3 window (self included) ``iters`` times over, background cells
    keep theirs. CUDA tensors launch the kernel (contiguous inputs
    required); CPU tensors take the plain twin. Any ``iters`` >= 1: one
    CUDA launch runs at most 8 sweeps, and a larger ``iters`` is split
    into ``ceil(iters / 8)`` launches of the same kernel (see
    ``sweep_plan``), which gives the labels one launch would. An empty
    batch (B, H or W = 0) returns an empty tensor without a launch. Past
    the kernel's grid (B > 65535, more than 65535 tiles down a map, or
    B*H*W >= 2^31) it raises ``ValueError`` before anything is allocated
    or launched.
    """
    _check(binary, labels)
    iters = int(iters)
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = binary.device
    if dev.type == "cpu":
        return neighbor_min_sweeps_plain(binary, labels, iters)
    b, h, w = binary.shape
    if b * h * w == 0:
        return torch.empty_like(labels)
    plan, cplan = _sweep_plan(h, w, iters)
    if b * h * w >= 2 ** 31 or max(b, plan.grid_rows) > _MAX_GRID_YZ:
        raise ValueError(
            f"batch {b}x{h}x{w} too large for int32 labels or the sweeps "
            f"kernel's grid (B <= {_MAX_GRID_YZ}, H <= "
            f"{_MAX_GRID_YZ * plan.tile} at iters={iters})"
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (binary.is_contiguous() and labels.is_contiguous()):
        raise ValueError("neighbor_min_sweeps needs contiguous tensors")
    out = torch.empty_like(labels)
    spare = torch.empty_like(labels) if plan.launches > 1 else None
    _sweeps_launch(dev.index, binary.data_ptr(), labels.data_ptr(),
                   out.data_ptr(), None if spare is None else spare.data_ptr(),
                   b, h, w, cplan)
    with _count_lock:
        neighbor_min_sweeps.launches += 1
        neighbor_min_sweeps.cuda_launches += plan.launches
    return out


# Wrapper calls that launched the CUDA kernel (CPU calls do not count), and
# the CUDA launches they made: ceil(iters / 8) a call.
neighbor_min_sweeps.launches = 0
neighbor_min_sweeps.cuda_launches = 0
