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
CUDA tensors launch ``csrc/neighbor_min_sweeps.cu``; CPU tensors run
``neighbor_min_sweeps_plain``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

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
            f"expected binary and labels of one [B,H,W] shape, got "
            f"{tuple(binary.shape)} and {tuple(labels.shape)}"
        )
    if binary.dtype != torch.bool or labels.dtype != torch.int32:
        raise TypeError(
            f"expected bool binary and int32 labels, got {binary.dtype} "
            f"and {labels.dtype}"
        )
    if binary.device != labels.device:
        raise ValueError("binary and labels are on different devices")


def _round_kernel():
    from .._build import load

    fn = load("segmented_cc").vtd_segmented_cc_round
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def segmented_cc_round(
    binary: torch.Tensor, labels: torch.Tensor, diag: bool = False
) -> torch.Tensor:
    """One segmented-propagation round over a batch of maps.

    binary [B,H,W] bool, labels [B,H,W] int32 -> new labels [B,H,W]
    int32; ``diag`` adds the diagonal ladders. CUDA tensors launch the
    kernel (contiguous inputs required); CPU tensors take the plain twin.
    """
    _check(binary, labels)
    if binary.device.type == "cpu":
        return segmented_cc_round_plain(binary, labels, diag)
    if binary.device.type != "cuda":
        raise ValueError(f"unsupported device {binary.device}")
    if not (binary.is_contiguous() and labels.is_contiguous()):
        raise ValueError("segmented_cc_round needs contiguous tensors")
    b, h, w = binary.shape
    if b * h * w >= 2 ** 31:
        raise ValueError("batch too large for int32 labels")
    scratch = torch.empty_like(labels)
    out = torch.empty_like(labels)
    stream = torch.cuda.current_stream(binary.device).cuda_stream
    with torch.cuda.device(binary.device):
        err = _round_kernel()(
            binary.data_ptr(), labels.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), b, h, w, int(bool(diag)), stream,
        )
    if err != 0:
        raise RuntimeError(f"segmented_cc_round launch failed: CUDA error {err}")
    with _count_lock:
        segmented_cc_round.launches += 1
    return out


# Launches of the CUDA kernel (CPU calls do not count).
segmented_cc_round.launches = 0


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


_SWEEP_TILE = 32  # kTile of csrc/neighbor_min_sweeps.cu
_SMEM_LIMIT = 232448  # dynamic shared memory one block can have on sm_90


def sweep_smem_bytes(iters: int) -> int:
    """Shared memory one block of the sweeps kernel needs: the tile plus a
    halo of ``iters`` cells, two int32 label buffers and a byte mask."""
    return (_SWEEP_TILE + 2 * iters) ** 2 * 9


def _sweeps_kernel():
    from .._build import load

    fn = load("neighbor_min_sweeps").vtd_neighbor_min_sweeps
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def neighbor_min_sweeps(
    binary: torch.Tensor, labels: torch.Tensor, iters: int = 8
) -> torch.Tensor:
    """``iters`` 8-neighbour minimum sweeps over a batch of maps.

    binary [B,H,W] bool, labels [B,H,W] int32 -> new labels [B,H,W]
    int32: foreground cells take the minimum label of their foreground
    3x3 window (self included) ``iters`` times over, background cells
    keep theirs. CUDA tensors launch the kernel (contiguous inputs
    required); CPU tensors take the plain twin.
    """
    _check(binary, labels)
    iters = int(iters)
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if binary.device.type == "cpu":
        return neighbor_min_sweeps_plain(binary, labels, iters)
    if binary.device.type != "cuda":
        raise ValueError(f"unsupported device {binary.device}")
    if not (binary.is_contiguous() and labels.is_contiguous()):
        raise ValueError("neighbor_min_sweeps needs contiguous tensors")
    if sweep_smem_bytes(iters) > _SMEM_LIMIT:
        raise ValueError(
            f"iters={iters} needs {sweep_smem_bytes(iters)} B of shared "
            f"memory per block, over the {_SMEM_LIMIT} B a block can have; "
            f"split the sweeps over several calls"
        )
    b, h, w = binary.shape
    if b * h * w >= 2 ** 31 or b > 65535 or h > 65535 * _SWEEP_TILE:
        raise ValueError("batch too large for the sweeps kernel's grid")
    out = torch.empty_like(labels)
    stream = torch.cuda.current_stream(binary.device).cuda_stream
    with torch.cuda.device(binary.device):
        err = _sweeps_kernel()(
            binary.data_ptr(), labels.data_ptr(), out.data_ptr(),
            b, h, w, iters, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"neighbor_min_sweeps launch failed: CUDA error {err}"
        )
    with _count_lock:
        neighbor_min_sweeps.launches += 1
    return out


# Launches of the CUDA kernel (CPU calls do not count).
neighbor_min_sweeps.launches = 0
