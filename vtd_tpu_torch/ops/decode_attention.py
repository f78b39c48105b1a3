"""Attention of one query token over a cached K/V: the TrOCR decoder's
greedy step (``models/trocr.py:Attention.decode``).

``decode_attention`` launches ``csrc/decode_attention.cu`` on a CUDA
tensor (design and bound in the note there) and runs
``decode_attention_plain`` on a CPU tensor: the arithmetic
``Attention.forward`` applies to one query token, scores and softmax in
float32 from ``cfg.dtype`` operands, the weights rounded to ``cfg.dtype``
before P.V. The kernel replaces no TPU kernel; the JAX package leaves
this attention to XLA.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .._build import kernel

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_CLUSTER = 8
# the kernel's block (csrc/decode_attention.cu): 256 threads, 4 loads in
# flight a thread
_THREADS, _UNROLL = 256, 4
_count_lock = threading.Lock()
_local = threading.local()  # launches made by each thread, captures included


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``Attention.forward``'s arithmetic for one
    query token, with the mask ``arange(T) <= pos`` when ``pos`` is
    given. q [B, H*hd], k and v [B, T, H, hd] -> [B, H*hd]."""
    b, t, h, hd = k.shape
    dtype = q.dtype
    qh = q.reshape(b, 1, h, hd)
    # scores accumulate in float32 from cfg.dtype operands
    attn = torch.matmul(
        qh.permute(0, 2, 1, 3).float(), k.permute(0, 2, 3, 1).float()
    ) * hd ** -0.5
    if pos is not None:
        attn = torch.where(torch.arange(t, device=k.device) <= pos, attn,
                           -1e30)
    attn = torch.softmax(attn, dim=-1).to(dtype)
    out = torch.matmul(attn, v.permute(0, 2, 1, 3).to(dtype))
    return out.permute(0, 2, 1, 3).reshape(b, h * hd)


def tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pos: Optional[torch.Tensor], want: torch.Tensor) -> torch.Tensor:
    """How far the kernel's output may lie from the plain version's
    ``want`` [B, H*hd], elementwise (float32). The kernel's float32 sums
    (dot products, the softmax's sum, P.V) run in another order than the
    plain version's GEMMs, so a weight rounded to the dtype, and the
    output, can land one place apart. One flipped weight moves an output
    by at most one ulp of that weight's term w*|v|, so 16-bit outputs are
    held within 2 ulps of the dtype at the larger of |output| and
    sum_t w_t*|v_t| (the scale of the sum's terms). Float32 rounds no
    weight: sums of T terms in any order lie within T*eps of
    sum_t w_t*|v_t| of the exact one, so both within 2*T*eps."""
    b, t, h, hd = k.shape
    scores = torch.matmul(q.reshape(b, h, 1, hd).float(),
                          k.permute(0, 2, 3, 1).float()) * hd ** -0.5
    if pos is not None:
        scores = torch.where(torch.arange(t, device=k.device) <= pos,
                             scores, -1e30)
    w = torch.softmax(scores, -1).to(q.dtype).float()
    terms = torch.matmul(w, v.permute(0, 2, 1, 3).float().abs())
    terms = terms.permute(0, 2, 1, 3).reshape(b, h * hd)
    finfo = torch.finfo(q.dtype)
    if q.dtype == torch.float32:
        return 2 * t * finfo.eps * terms
    scale = torch.maximum(want.float().abs(), terms).clamp(min=finfo.tiny)
    return 2 * torch.exp2(torch.floor(torch.log2(scale))) * finfo.eps


def _check(q, k, v, pos) -> None:
    if k.dim() != 4 or v.shape != k.shape or k.shape[1] < 1:
        raise ValueError(
            f"expected k and v of one [B, T, H, hd] shape with T >= 1, got "
            f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, _, h, hd = k.shape
    if q.shape != (b, h * hd):
        raise ValueError(
            f"expected q [B, H*hd] = [{b}, {h * hd}], got {tuple(q.shape)}")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"expected q, k and v of one of {sorted(map(str, _CODES))}, got "
            f"{q.dtype}, {k.dtype} and {v.dtype}")
    if pos is not None and (pos.dtype != torch.int64 or pos.numel() != 1):
        raise TypeError(f"expected pos int64 [1], got {pos.dtype} "
                        f"{tuple(pos.shape)}")
    tensors = (q, k, v) if pos is None else (q, k, v, pos)
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v and pos are on different devices")
    inner = (h * hd, hd, 1)
    if (not q.is_contiguous() or k.stride()[1:] != inner
            or v.stride()[1:] != inner):
        raise ValueError(
            f"expected contiguous q and [T, H, hd] dimensions of k and v "
            f"contiguous (strides {inner}), got {k.stride()[1:]} and "
            f"{v.stride()[1:]}")


def pass_positions(hd: int, esize: int) -> int:
    """Positions a block of the kernel reads in one pass of its loop:
    each position's row takes a group of lanes, one 16-byte load each
    (hd * esize / 16 loads, rounded up to a power of two, at least 2),
    and every thread issues 4 loads before it uses one."""
    lanes = 2
    while lanes < hd * esize // 16:
        lanes *= 2
    return _THREADS // lanes * _UNROLL


def cluster_size(rows: int, heads: int, t: int, per_pass: int,
                 sms: int) -> int:
    """Blocks each (row, head) pair's cluster gets: the least power of two
    (up to 8) that puts two blocks on every one of ``sms`` SMs, but no
    more than leaves each block a full pass (``per_pass`` positions) of
    the T. A cache shorter than two passes is one block's, with no
    exchange across the cluster."""
    c = 1
    while (c < _MAX_CLUSTER and rows * heads * c < 2 * sms
           and 2 * c * per_pass <= t):
        c *= 2
    return c


_sms = {}
_launch = kernel(
    "decode_attention", "vtd_decode_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6
    + [ctypes.c_float],
)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query token's attention over a cached K/V.

    q [B, H*hd] (the projected query), k and v [B, T, H, hd] in their
    stored layout (any row stride; the [T, H, hd] dimensions contiguous),
    ``pos`` an int64 [1] on the device: positions 0..pos are attended (pos
    in [0, T)), all T without it. Returns [B, H*hd] in q's dtype (float32,
    bfloat16 or float16). CUDA tensors launch the kernel (hd a multiple
    of 8 in [16, 128], 16-byte aligned data and row strides), CPU tensors
    take the plain version.
    """
    _check(q, k, v, pos)
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, pos)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise RuntimeError("decode_attention's kernel has no backward: "
                           "call it under torch.no_grad or inference_mode")
    b, t, h, hd = k.shape
    esize = q.element_size()
    if not (16 <= hd <= 128 and hd % 8 == 0):
        raise ValueError(f"decode_attention needs hd a multiple of 8 in "
                         f"[16, 128], got {hd}")
    if (b > 65535 or h > 65535 or any(
            x.data_ptr() % 16 for x in (q, k, v))
            or (k.stride(0) * esize) % 16 or (v.stride(0) * esize) % 16):
        raise ValueError(
            "decode_attention needs B and H <= 65535, 16-byte aligned q, k "
            "and v, and row strides of whole 16-byte words")
    sms = _sms.get(dev.index)
    if sms is None:
        sms = _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    out = torch.empty_like(q)
    _launch(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if pos is None else pos.data_ptr(),
            k.stride(0), v.stride(0), b, t, h, hd, _CODES[q.dtype],
            cluster_size(b, h, t, pass_positions(hd, esize), sms), hd ** -0.5)
    _local.n = getattr(_local, "n", 0) + 1
    count_launches(1)
    return out


def launches_in_thread() -> int:
    """Kernel launches this thread's wrapper calls made, those recorded
    into a CUDA graph's capture included."""
    return getattr(_local, "n", 0)


def count_launches(n: int) -> None:
    """Add ``n`` to ``decode_attention.launches``: a captured graph's
    launches run at each replay, not at its capture (a capture takes
    its own back with a negative ``n``)."""
    with _count_lock:
        decode_attention.launches += n


# Kernel launches the card ran (CPU calls do not count).
decode_attention.launches = 0
