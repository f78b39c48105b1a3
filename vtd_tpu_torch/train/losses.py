"""DBNet training losses (port of ``vtd_tpu/train/losses.py``).

total = BCE(probability) + BCE(threshold) + Dice(probability), BCE on
probabilities clipped to [EPS, 1 - EPS] before the logs, as the
reference takes them. ``F.binary_cross_entropy`` would clamp each log at
-100 instead, which differs wherever a probability is within EPS of 0
or 1.

Inside ``parallel.collectives.data_group`` each loss is the whole
batch's across the ranks: BCE from the all-reduced error sum and count,
Dice from the all-reduced ``sum p*t``, ``sum p`` and ``sum t`` (a mean of
per-rank Dice losses is not the global Dice).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..parallel.collectives import all_reduce_sum, current_data_group

EPS = 1e-7


def _per_sample(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(torch.float32).reshape((-1,) + (1,) * (like.dim() - 1))


def bce_loss(
    pred: torch.Tensor, target: torch.Tensor,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Binary cross-entropy on probabilities. ``sample_weight``: optional
    [B] per-sample weights (0 keeps a padding sample out of the mean)."""
    p = pred.to(torch.float32).clamp(EPS, 1.0 - EPS)
    t = target.to(torch.float32)
    err = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    group = current_data_group()
    if sample_weight is None:
        if group is None:
            return err.mean()
        total, n = all_reduce_sum(
            torch.stack([err.sum(), err.new_tensor(float(err.numel()))]),
            group)
        return total / n
    w = _per_sample(sample_weight, err)
    total, n = (err * w).sum(), w.sum() * err[0].numel()
    if group is not None:
        total, n = all_reduce_sum(torch.stack([total, n]), group)
    return total / torch.clamp(n, min=1.0)


def dice_loss(
    pred: torch.Tensor, target: torch.Tensor, smooth: float = 1e-5,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    p = pred.to(torch.float32)
    t = target.to(torch.float32)
    if sample_weight is not None:
        w = _per_sample(sample_weight, p)
        p = p * w
        t = t * w
    inter, p_sum, t_sum = (p * t).sum(), p.sum(), t.sum()
    group = current_data_group()
    if group is not None:
        inter, p_sum, t_sum = all_reduce_sum(
            torch.stack([inter, p_sum, t_sum]), group)
    dice = (2.0 * inter + smooth) / (p_sum + t_sum + smooth)
    return 1.0 - dice


def db_loss(
    outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
    sample_weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``outputs`` hold 'probability'/'threshold' maps ([B,H,W], or
    [B,1,H,W] as the port's DBNet returns them), ``targets``
    'probability_map'/'threshold_map' [B,H,W]. ``sample_weight``: optional
    [B] weights; evaluation passes the batch's validity mask."""
    prob = outputs["probability"]
    thresh = outputs["threshold"]
    prob_t = targets["probability_map"]
    thresh_t = targets["threshold_map"]
    if prob.dim() == prob_t.dim() + 1:  # [B,1,H,W] against [B,H,W]
        prob = prob[:, 0]
        thresh = thresh[:, 0]
    p_l = bce_loss(prob, prob_t, sample_weight)
    t_l = bce_loss(thresh, thresh_t, sample_weight)
    d_l = dice_loss(prob, prob_t, sample_weight=sample_weight)
    total = p_l + t_l + d_l
    return total, {
        "loss": total,
        "prob_loss": p_l,
        "thresh_loss": t_l,
        "dice_loss": d_l,
    }
