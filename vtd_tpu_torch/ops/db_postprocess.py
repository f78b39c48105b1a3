"""DB probability-map postprocess on the device, batched.

Port of ``vtd_tpu/ops/db_postprocess.py``: threshold -> 8-connected
components at ``work_stride`` -> one stable key-value sort that serves
both the top-K components and their boundary cells -> rotating-calipers
min-area rectangle (coarse sweep, three refinement stages, exact extents
over every boundary pixel) -> box mean probability from an integral
image. The JAX function runs once per frame under ``vmap``; here the
batch dimension is written out, and every tensor carries it first. The
per-map functions also take the reference's single map (``[H, W]``),
run it as a batch of one and return the reference's unbatched shapes.

Each propagation round of the labelling goes through
``cc_kernels.segmented_cc_round`` (the CUDA kernel on a CUDA tensor); the
dense backends of ``connected_components`` go through
``cc_kernels.neighbor_min_sweeps``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from ..obs import trace
from ._rank import one_or_batch
from .cc_kernels import (
    BIG, neighbor_min_sweeps, neighbour_min, segmented_cc_round,
)


def _stable(binary: torch.Tensor, lbl: torch.Tensor) -> torch.Tensor:
    """[B] bool: labels constant across every 8-neighbour edge of each
    map (one min8 step changes nothing) <=> the exact labelling."""
    m8 = neighbour_min(torch.where(binary, lbl, BIG))
    return torch.where(binary, m8 >= lbl, True).flatten(1).all(1)


@one_or_batch("H, W", "binary")
def connected_components_scan(
    binary: torch.Tensor, min_rounds: int = 3, max_rounds: int = 3
) -> torch.Tensor:
    """8-connected component labels for [H, W] or [B, H, W] bool maps ->
    [H*W] or [B, H*W] int32 (``db_postprocess.py:79-235``).

    ``min_rounds`` rounds run unconditionally, with the diagonal ladders
    on the second and no pointer jump. When ``max_rounds > min_rounds``
    a repair loop of diagonal rounds plus a pointer jump follows, seeded
    by a stability check; as under the reference's ``vmap`` of a
    ``while_loop``, a map that has converged (or used up its rounds)
    keeps its labels while the others go on. The host waits on the
    device once for the stability check and once per repair round.
    """
    b, h, w = binary.shape
    hw = h * w
    lbl = (
        torch.arange(hw, dtype=torch.int32, device=binary.device)
        .reshape(1, h, w)
        .expand(b, h, w)
        .contiguous()
    )
    binary = binary.contiguous()
    for i in range(min_rounds):
        lbl = segmented_cc_round(binary, lbl, diag=(i == 1))
    if max_rounds > min_rounds:
        active = ~_stable(binary, lbl)
        rounds = min_rounds
        while rounds < max_rounds:
            with trace.span("vtd.cc_sync"):  # the host waits for the device
                if not bool(active.any()):
                    break
            nxt = segmented_cc_round(binary, lbl, diag=True)
            flat = nxt.reshape(b, hw)
            nxt = torch.gather(flat, 1, flat.long()).reshape(b, h, w)
            changed = (nxt != lbl).flatten(1).any(1)
            lbl = torch.where(active[:, None, None], nxt, lbl)
            active = active & changed
            rounds += 1
    return lbl.reshape(b, hw)


_DENSE_BACKENDS = ("pallas", "pallas-auto", "xla")


@one_or_batch("H, W", "binary")
def connected_components(
    binary: torch.Tensor,
    dense_iters: int = 8,
    jump_rounds: int = 4,
    backend: str = "auto",
    exact: bool = False,
) -> torch.Tensor:
    """[H, W] or [B, H, W] bool -> [H*W] or [B, H*W] int32 labels: each
    foreground cell holds one label shared by its whole component,
    background cells their own index (``db_postprocess.py:238-303``).

    ``backend`` "auto" / "scan": the production schedule, 3 unrolled
    segmented rounds and a repair loop of up to 16 rounds (32 with
    ``exact``). On a CUDA tensor its kernel takes maps of at most 8607
    cells in H and in W (``cc_kernels.segmented_plan``) and raises
    ``ValueError`` past that; ``db_postprocess`` hands it maps of
    ``detector_input_size / work_stride`` cells a side. The reference's dense backends "pallas", "pallas-auto"
    and "xla" all name one schedule here: ``jump_rounds`` rounds of
    ``neighbor_min_sweeps(iters=dense_iters)`` and one pointer jump
    (``label <- label[label]``) per map; the sweeps wrapper picks the CUDA
    kernel or the plain version by the tensor's device, so the three
    strings do not differ. That schedule reproduces the reference's
    result label for label; it is the exact labelling only for components
    its reach covers.
    """
    if backend in ("auto", "scan"):
        return connected_components_scan(
            binary, max_rounds=32 if exact else 16
        )
    if backend not in _DENSE_BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected 'auto', 'scan' or one "
            f"of {_DENSE_BACKENDS}"
        )
    b, h, w = binary.shape
    hw = h * w
    binary = binary.contiguous()
    lbl = (
        torch.arange(hw, dtype=torch.int32, device=binary.device)
        .reshape(1, h, w)
        .expand(b, h, w)
        .contiguous()
    )
    for _ in range(jump_rounds):
        flat = neighbor_min_sweeps(binary, lbl, iters=dense_iters).reshape(
            b, hw
        )
        lbl = torch.gather(flat, 1, flat.long()).reshape(b, h, w)
    return lbl.reshape(b, hw)


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, [1]), 1).values, [1])


def _topk_lower_index_first(
    scores: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer top-k along dim 1 with ties broken by lower index first,
    as ``jax.lax.top_k`` does: one int64 key (score, -index) per cell."""
    n = scores.shape[1]
    idx = torch.arange(n, device=scores.device, dtype=torch.int64)
    key = scores.to(torch.int64) * n + (n - 1 - idx)
    top = torch.topk(key, k, dim=1, sorted=True).values
    return top // n, (n - 1) - top % n


@one_or_batch("H, W", "prob_map")
def db_postprocess(
    prob_map: torch.Tensor,
    bin_thresh: float | torch.Tensor = 0.5,
    *,
    max_dets: int = 64,
    min_area: float = 100.0,
    max_box_frac: float = 0.95,
    num_angles: int = 45,
    refine_steps: int = 9,
    cc_iters: int = 8,
    work_stride: int = 2,
    stage: str = "full",
    cc_exact: bool = False,
    m_cells: int | None = None,
) -> Dict[str, torch.Tensor]:
    """[B, H, W] probability maps -> fixed-size detection tensors.

    Returns (full-resolution map coordinates; K = ``max_dets``):
      boxes [B,K,4] (x1,y1,x2,y2), polygons [B,K,4,2], scores [B,K],
      areas [B,K], valid [B,K] bool, and xmin/xmax/ymin/ymax [B,K].
    One map [H, W] (``bin_thresh`` a float or a 0-d tensor) gives the
    same without the batch axis, as the reference's function does.

    ``cc_iters`` goes to ``connected_components(dense_iters=...)``, as in
    the reference; its default "auto" backend takes no sweeps, so the
    value changes nothing there. ``stage`` cuts the work short for
    profiling, returning what the
    reference returns there, batched: ``"cc"`` {labels [B, n]},
    ``"topk"`` {roots, areas, valid [B, K]}, ``"boundary"`` {xs, ys,
    pmask [B, K, M], valid}.
    """
    if stage not in ("full", "cc", "topk", "boundary"):
        raise ValueError(f"unknown stage {stage!r}")
    bsz, h, w = prob_map.shape
    k = max_dets
    st = work_stride
    dev = prob_map.device
    f32 = torch.float32

    binary_full = prob_map > bin_thresh
    hs, ws = h // st, w // st
    n = hs * ws
    binary = (
        binary_full[:, : hs * st, : ws * st]
        .reshape(bsz, hs, st, ws, st)
        .any(4)
        .any(2)
    )
    labels = connected_components(
        binary, dense_iters=cc_iters, exact=cc_exact
    )  # [B, n]
    if stage == "cc":
        return {"labels": labels}

    # ---- full-resolution 4-boundary, folded to per-cell pixel bits ----
    hf, wf = hs * st, ws * st
    bin_f = binary_full[:, :hf, :wf]
    padded = torch.nn.functional.pad(bin_f.to(torch.uint8), (1, 1, 1, 1))
    interior = (
        padded[:, :-2, 1:-1] & padded[:, 2:, 1:-1]
        & padded[:, 1:-1, :-2] & padded[:, 1:-1, 2:]
    ).bool()
    bnd4 = (
        (bin_f & ~interior)
        .reshape(bsz, hs, st, ws, st)
        .permute(0, 1, 3, 2, 4)
        .reshape(bsz, n, st * st)
    )
    cell_has_b = bnd4.any(2)

    # ---- one stable key-value sort: area top-K and boundary grouping --
    stsq = st * st
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    key = labels * 2 + (~cell_has_b).to(torch.int32)
    jj = torch.arange(stsq, dtype=torch.int32, device=dev)
    exact_extents = n * (1 << stsq) < 2 ** 31
    if exact_extents:
        bnd_bits = (bnd4.to(torch.int32) * (1 << jj)).sum(2, dtype=torch.int32)
        payload = idx * (1 << stsq) + bnd_bits
    else:
        payload = idx.expand(bsz, n)
    ls_key, order = torch.sort(key, dim=1, stable=True)
    payload_sorted = torch.gather(payload, 1, order)
    cell_sorted = (
        payload_sorted // (1 << stsq) if exact_extents else payload_sorted
    )
    ls = ls_key // 2

    # component areas + top-K roots from run lengths of the sorted labels
    is_start = torch.cat(
        [
            torch.ones(bsz, 1, dtype=torch.bool, device=dev),
            ls[:, 1:] != ls[:, :-1],
        ],
        1,
    )
    nxt_start = torch.roll(torch.where(is_start, idx, n), -1, 1)
    nxt_start[:, -1] = n
    nxt = _rev_cummin(nxt_start)
    run_len = torch.where(is_start, nxt - idx, 0)
    # runs of length 1 are background cells (see the reference's note)
    top_lens, top_pos = _topk_lower_index_first(
        torch.where(run_len > 1, run_len, 0), k
    )
    top_roots = torch.gather(ls, 1, top_pos)
    areas = top_lens.to(f32) * (st * st)
    valid = areas >= min_area
    safe_roots = torch.where(valid, top_roots, n).to(torch.int32)
    if stage == "topk":
        return {"roots": safe_roots, "areas": areas, "valid": valid}

    # ---- per-component boundary cells -> full-res pixel coordinates ---
    if m_cells is None:
        m_cells = max(1024 // (st * st), 32)
    starts = torch.searchsorted(ls_key, safe_roots * 2, side="left")
    ends = torch.searchsorted(ls_key, safe_roots * 2 + 1, side="left")
    blen = torch.clamp(ends - starts, min=1)
    mm = torch.arange(m_cells, dtype=torch.int64, device=dev)
    sel = torch.where(
        (blen > m_cells)[..., None],
        (mm * blen[..., None]) // m_cells,
        torch.minimum(mm, blen[..., None] - 1),
    )
    gidx = torch.clamp(starts[..., None] + sel, 0, n - 1)  # [B, K, M]
    cells = torch.gather(cell_sorted, 1, gidx.reshape(bsz, -1)).reshape(
        bsz, k, m_cells
    )
    jx = (jj % st)[None, None, None, :]
    jy = (jj // st)[None, None, None, :]
    xs_c = ((cells % ws)[..., None] * st + jx).to(f32).reshape(bsz, k, -1)
    ys_c = ((cells // ws)[..., None] * st + jy).to(f32).reshape(bsz, k, -1)
    cell_mask = mm < blen[..., None]
    bidx = torch.arange(bsz, device=dev)[:, None, None]
    pmask = (cell_mask[..., None] & bnd4[bidx, cells.long()]).reshape(
        bsz, k, -1
    )
    if stage == "boundary":
        return {"xs": xs_c, "ys": ys_c, "pmask": pmask, "valid": valid}
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)

    def cal_minmax(vals):
        vmin = torch.where(pmask, vals, inf).amin(2)
        vmax = torch.where(pmask, vals, -inf).amax(2)
        return vmin, vmax

    def rect_area(c, s):
        umin, umax = cal_minmax(xs_c * c + ys_c * s)
        vmin, vmax = cal_minmax(-xs_c * s + ys_c * c)
        return (umax - umin) * (vmax - vmin)

    # ---- coarse angle search (rotating calipers) ----------------------
    # Angles and their cosines are float32 scalars computed as the
    # reference traces them: (pi/2 as f32) * j / num_angles.
    best_area = torch.full((bsz, k), float("inf"), dtype=f32, device=dev)
    best_theta = torch.zeros((bsz, k), dtype=f32, device=dev)
    half_pi = torch.tensor(math.pi / 2, dtype=f32, device=dev)
    for j in range(num_angles):
        theta = half_pi * j / num_angles
        a = rect_area(torch.cos(theta), torch.sin(theta))
        better = a < best_area
        best_area = torch.where(better, a, best_area)
        best_theta = torch.where(better, theta, best_theta)

    # ---- three refinement stages around the best angle ----------------
    span = (math.pi / 2) / num_angles
    theta = best_theta
    for _stage in range(3):
        center = theta
        best_area = torch.full_like(best_area, float("inf"))
        best_t = theta
        for r in range(refine_steps):
            # float32 steps, as the reference traces frac * span
            frac = np.float32(r) / np.float32(max(refine_steps - 1, 1))
            frac = frac * np.float32(2.0) - np.float32(1.0)
            cand = center + float(frac * np.float32(span))
            a = rect_area(torch.cos(cand)[..., None], torch.sin(cand)[..., None])
            better = a < best_area
            best_area = torch.where(better, a, best_area)
            best_t = torch.where(better, cand, best_t)
        theta = best_t
        span = span * 2.0 / max(refine_steps - 1, 1)

    # ---- final extents + corners at the refined angle -----------------
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    umin, umax = cal_minmax(xs_c * c + ys_c * s)
    vmin, vmax = cal_minmax(-xs_c * s + ys_c * c)
    ex_aabb = None
    if exact_extents:
        # Exact extents over every boundary pixel at each component's own
        # angle: one segmented min over the label-sorted cells. Each
        # position gathers its run's cosine and sine, exact float32.
        slot_by_start = torch.argsort(starts, dim=1, stable=True)
        sstarts = torch.gather(starts, 1, slot_by_start).contiguous()
        sends = torch.gather(ends, 1, slot_by_start).contiguous()
        idx64 = idx.to(torch.int64).expand(bsz, n).contiguous()
        rank_raw = torch.searchsorted(sstarts, idx64, side="right") - 1
        ended = torch.searchsorted(sends, idx64, side="right")
        in_run = (ended == rank_raw) & (rank_raw >= 0)
        rank = torch.clamp(rank_raw, 0, k - 1)
        tab = torch.stack(
            [
                torch.gather(torch.cos(theta), 1, slot_by_start),
                torch.gather(torch.sin(theta), 1, slot_by_start),
            ],
            2,
        )  # [B, K, 2]
        mapped = torch.gather(tab, 1, rank[..., None].expand(-1, -1, 2))
        c_p, s_p = mapped[..., 0], mapped[..., 1]  # [B, n]

        cxf = ((cell_sorted % ws) * st).to(f32)
        cyf = ((cell_sorted // ws) * st).to(f32)
        bits = payload_sorted % (1 << stsq)
        red = None
        for j in range(stsq):
            on = (((bits >> j) % 2) == 1) & in_run
            xj, yj = cxf + (j % st), cyf + (j // st)
            u = xj * c_p + yj * s_p
            v = yj * c_p - xj * s_p
            vals = torch.stack([u, -u, v, -v, xj, -xj, yj, -yj], 2)
            vals = torch.where(on[..., None], vals, inf)
            red = vals if red is None else torch.minimum(red, vals)
        # segmented min over each run of equal labels
        run_id = torch.cumsum(is_start.to(torch.int64), 1) - 1  # [B, n]
        per_run = torch.full((bsz, n, 8), float("inf"), dtype=f32, device=dev)
        per_run.scatter_reduce_(
            1, run_id[..., None].expand(bsz, n, 8), red, "amin",
            include_self=True,
        )
        run_end = torch.clamp(
            torch.searchsorted(ls, safe_roots, side="right") - 1, 0, n - 1
        )
        g_run = torch.gather(run_id, 1, run_end)  # [B, K]
        g = torch.gather(per_run, 1, g_run[..., None].expand(bsz, k, 8))
        have = torch.isfinite(g[..., 0])
        umin = torch.where(have, g[..., 0], umin)
        umax = torch.where(have, -g[..., 1], umax)
        vmin = torch.where(have, g[..., 2], vmin)
        vmax = torch.where(have, -g[..., 3], vmax)
        ex_aabb = (
            torch.where(have, g[..., 4], 0.0),
            torch.where(have, -g[..., 5], 0.0),
            torch.where(have, g[..., 6], 0.0),
            torch.where(have, -g[..., 7], 0.0),
            have,
        )
    c, s = c[..., 0], s[..., 0]

    uu = torch.stack([umin, umax, umax, umin], 2)  # [B, K, 4]
    vv = torch.stack([vmin, vmin, vmax, vmax], 2)
    px = uu * c[..., None] - vv * s[..., None]
    py = uu * s[..., None] + vv * c[..., None]
    polygons = torch.stack([px, py], -1)  # [B, K, 4, 2]

    bx1 = torch.clamp(px.amin(2), 0, w)
    by1 = torch.clamp(py.amin(2), 0, h)
    bx2 = torch.clamp(px.amax(2), 0, w)
    by2 = torch.clamp(py.amax(2), 0, h)
    boxes = torch.stack([bx1, by1, bx2, by2], 2)

    # ---- confidence: mean probability inside the AABB ------------------
    # float32 integral image: a bf16 map summed in bf16 would drift.
    ii = torch.cumsum(torch.cumsum(prob_map.to(f32), 1), 2)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
    ix1 = torch.clamp(bx1.to(torch.int64), 0, w - 1)
    iy1 = torch.clamp(by1.to(torch.int64), 0, h - 1)
    ix2 = torch.minimum(torch.maximum(torch.ceil(bx2).to(torch.int64), ix1 + 1),
                        torch.tensor(w, device=dev))
    iy2 = torch.minimum(torch.maximum(torch.ceil(by2).to(torch.int64), iy1 + 1),
                        torch.tensor(h, device=dev))
    ii_flat = ii.reshape(bsz, -1)

    def at(yy, xx):
        return torch.gather(ii_flat, 1, yy * (w + 1) + xx)

    box_sum = at(iy2, ix2) - at(iy1, ix2) - at(iy2, ix1) + at(iy1, ix1)
    npix = ((ix2 - ix1) * (iy2 - iy1)).to(f32)
    scores = box_sum / torch.clamp(npix, min=1.0)

    # frame-filling components are border artifacts (reference note);
    # max_box_frac >= 1 disables the filter
    if max_box_frac < 1.0:
        frame_filling = (bx2 - bx1 >= max_box_frac * w) & (
            by2 - by1 >= max_box_frac * h
        )
        valid = valid & ~frame_filling

    def mask(x):
        m = valid.reshape(valid.shape + (1,) * (x.dim() - 2))
        return torch.where(m, x, 0.0)

    xmin, xmax = cal_minmax(xs_c)
    ymin, ymax = cal_minmax(ys_c)
    if ex_aabb is not None:
        exmin, exmax, eymin, eymax, have = ex_aabb
        xmin = torch.where(have, exmin, xmin)
        xmax = torch.where(have, exmax, xmax)
        ymin = torch.where(have, eymin, ymin)
        ymax = torch.where(have, eymax, ymax)

    return {
        "boxes": mask(boxes),
        "polygons": mask(polygons),
        "scores": mask(scores),
        "areas": areas,
        "valid": valid,
        "xmin": mask(xmin), "xmax": mask(xmax),
        "ymin": mask(ymin), "ymax": mask(ymax),
    }


def db_postprocess_batch(
    prob_maps: torch.Tensor, bin_thresh: float | torch.Tensor = 0.5, **kw
) -> Dict[str, torch.Tensor]:
    """Batched [B, H, W] entry point of the reference's name (keywords as
    :func:`db_postprocess`); batches only, as the reference's."""
    if prob_maps.dim() != 3:
        raise ValueError(
            f"db_postprocess_batch takes [B, H, W] maps, got "
            f"{tuple(prob_maps.shape)}")
    return db_postprocess(prob_maps, bin_thresh, **kw)


def extract_detections(
    post: Dict[str, np.ndarray],
    orig_width: int,
    orig_height: int,
    map_size: int = 640,
    min_box_px: int = 10,
) -> List[Dict[str, Any]]:
    """Host side: fixed-size arrays for ONE frame -> detection dicts
    (bbox in original-frame ints, polygon in map space, the >10 px size
    filter in original coordinates), as ``vtd_tpu``'s function."""
    boxes = np.asarray(post["boxes"])
    polys = np.asarray(post["polygons"])
    scores = np.asarray(post["scores"])
    valid = np.asarray(post["valid"])

    out: List[Dict[str, Any]] = []
    sx = orig_width / map_size
    sy = orig_height / map_size
    for i in range(boxes.shape[0]):
        if not valid[i]:
            continue
        x1 = int(boxes[i, 0] * sx)
        y1 = int(boxes[i, 1] * sy)
        x2 = int(boxes[i, 2] * sx)
        y2 = int(boxes[i, 3] * sy)
        if x2 - x1 <= min_box_px or y2 - y1 <= min_box_px:
            continue
        out.append(
            {
                "bbox": [x1, y1, x2, y2],
                "confidence": float(scores[i]),
                "polygon": np.round(polys[i]).astype(int).tolist(),
            }
        )
    return out
