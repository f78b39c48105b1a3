"""DBNet trainer (port of ``vtd_tpu/train/trainer.py``).

The reference's behaviour, on one card:

  * loss = BCE(prob) + BCE(thresh) + Dice(prob)      (``losses.py``)
  * AdamW, lr 1e-4, weight decay 1e-5 (torch's AdamW with betas (0.9,
    0.999) and eps 1e-8 computes optax's ``adamw`` update)
  * the plateau rule on val_loss (factor 0.5, patience 5), which scales
    the optimizer's learning rate
  * val precision / recall / F1 at 0.5, counted on the device and masked
    by the batch's validity
  * top-k checkpoints by val_loss (stale ones deleted), early stopping
  * ``ModelTrainer.train`` / ``.evaluate`` and their result dicts.

Checkpoints are the port's torch format (``epoch<E>-val<L>.pt`` state
dicts), which ``TextDetector(model_path=...)`` loads as they are.

``mesh`` trains data-parallel with one process per data-axis entry
(``torch.distributed``; ``train-detector --mesh Dx1`` spawns them): every
rank iterates the same shuffled global batches and takes its
``local_batch_slice``; BatchNorm statistics and the losses are the whole
batch's (``parallel.collectives.data_group``); the gradients are averaged
over the ranks after backward, so AdamW takes the same step everywhere;
evaluation's loss and confusion counts are global; rank 0 writes the
checkpoints (plain state dicts). On a mesh with a model axis each rank
splits its model over its own row (``core.mesh.rank_row``,
``parallel.tensor_parallel``) before AdamW is built: the batch and every
replicated layer on the row's first entry, the shards of the wide layers
on its entries; the checkpoints hold the full state dict, which an
unsplit ``TextDetector`` loads. ``train-detector --mesh DxM`` spawns D
ranks, not D*M.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device, seeded_init_
from ..core.mesh import DATA_AXIS, MODEL_AXIS, local_batch_slice, rank_row
from ..parallel.collectives import average_gradients, data_group
from ..parallel.tensor_parallel import tensor_parallel_
from .checkpoint import save_state_dict
from .losses import db_loss

logger = logging.getLogger(__name__)


class TextDetectionDataset:
    """In-memory dataset of (image, target) pairs.

    images: [N, H, W, 3] float32 (normalised, NHWC as the reference's);
    targets: dict with 'probability_map' and 'threshold_map', each
    [N, H, W].
    """

    def __init__(self, images, targets, transform=None):
        self.images = np.asarray(images, np.float32)
        self.targets = {
            k: np.asarray(v, np.float32) for k, v in targets.items()
        }
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0,
        with_valid: bool = False,
    ) -> Iterable[Tuple]:
        """Fixed-size batches; the tail batch is filled by tiling the
        dataset. ``with_valid=True`` also yields a [batch_size] bool mask
        of the real (not tiled) samples, which evaluation needs."""
        n = len(self)
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for i in range(0, n, batch_size):
            sel = idx[i:i + batch_size]
            n_real = len(sel)
            if n_real < batch_size:
                reps = -(-(batch_size - n_real) // n)  # ceil
                sel = np.concatenate([sel] + [idx] * reps)[:batch_size]
            imgs = self.images[sel]
            if self.transform:
                imgs = self.transform(imgs)
            targets = {k: v[sel] for k, v in self.targets.items()}
            if with_valid:
                valid = np.zeros(batch_size, bool)
                valid[:n_real] = True
                yield imgs, targets, valid
            else:
                yield imgs, targets


def create_train_state(
    model: torch.nn.Module,
    learning_rate: float = 1e-4,
    weight_decay: float = 1e-5,
    weights: Optional[Dict[str, torch.Tensor]] = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
    row: Optional[Sequence] = None,
) -> Dict[str, Any]:
    """The model's weights (``weights``, a port state dict, or drawn from
    ``seed`` as ``core.device.seeded_init_`` draws them), on ``device``,
    and AdamW over its parameters. With ``row`` (a mesh row of two or
    more devices) the model is split over the row instead, its first
    entry in the place of ``device``, before AdamW takes its parameters.
    The learning rate lives in the optimizer's ``param_groups``, where the
    plateau rule scales it."""
    dev = resolve_device(row[0] if row else device)
    if weights is not None:
        model.load_state_dict(weights)
    else:
        seeded_init_(model, seed)
    tensor_parallel_(model, row or [dev])
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay,
    )
    return {"model": model, "optimizer": optimizer, "device": dev}


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2)


def make_train_step(
    model: torch.nn.Module, optimizer: torch.optim.Optimizer,
    group: Optional[dist.ProcessGroup] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(images [B,H,W,3], targets) -> aux`` (0-d loss tensors on the
    device): one forward in train mode (BatchNorm on batch statistics,
    running statistics updated), the DB loss, backward and an AdamW
    update. The step's gradients stay in the parameters' ``.grad`` until
    the next step clears them. Under a data-parallel ``group`` the images
    are this rank's slice, the statistics and the loss are the whole
    batch's, and ``.grad`` holds the gradient averaged over the ranks."""

    def train_step(images: torch.Tensor, targets: Dict[str, torch.Tensor]):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with data_group(group):
            total, aux = db_loss(model(_nchw(images)), targets)
        total.backward()
        if group is not None:
            average_gradients(model.parameters(), group)
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    return train_step


def make_eval_step(model: torch.nn.Module,
                   group: Optional[dist.ProcessGroup] = None):
    """``step(images, targets, valid) -> aux`` with the loss weighted by
    ``valid`` and tp / fp / fn of the probability map at 0.5, masked so
    that tail padding counts nothing. Under a data-parallel ``group``,
    the loss and the counts are the whole batch's."""

    @torch.no_grad()
    def eval_step(images, targets, valid):
        model.eval()
        out = model(_nchw(images))
        with data_group(group):
            _, aux = db_loss(out, targets, sample_weight=valid)
        w = valid.to(torch.float32)[:, None, None]
        pred = (out["probability"][:, 0] > 0.5).to(torch.float32)
        tgt = targets["probability_map"]
        counts = torch.stack([
            (pred * tgt * w).sum(),
            (pred * (1 - tgt) * w).sum(),
            ((1 - pred) * tgt * w).sum(),
        ])
        if group is not None:
            dist.all_reduce(counts, group=group)
        aux.update(zip(("tp", "fp", "fn"), counts))
        return aux

    return eval_step


class ModelTrainer:
    """Training driver. config keys: checkpoint_dir, max_epochs,
    learning_rate, weight_decay, batch_size, seed, early_stop_patience
    (10), plateau_patience (5), plateau_factor (0.5), save_top_k (3)."""

    def __init__(self, config: Dict[str, Any], mesh: Optional[Any] = None,
                 device: str = "cuda"):
        self.config = dict(config)
        self.mesh = mesh
        self.device = resolve_device(device)

    def _row(self) -> Optional[List[torch.device]]:
        """This rank's mesh row when the mesh has a model axis, else None.
        The row's first entry becomes the trainer's device (and on the
        card the current one): the batches, the collectives and every
        replicated layer live there."""
        if self.mesh is None or self.mesh.shape[MODEL_AXIS] == 1:
            return None
        row = rank_row(self.mesh)
        self.device = row[0]
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        return row

    def _data_parallel(self, batch_size: int):
        """(group, (start, size) of this rank's rows): (None, whole batch)
        without a mesh, or on a 1-entry mesh outside any group."""
        if self.mesh is None:
            return None, (0, batch_size)
        n = self.mesh.shape[DATA_AXIS]
        if batch_size % n:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"the mesh data axis ({n})")
        if not dist.is_initialized():
            if n == 1:
                return None, (0, batch_size)
            raise ValueError(
                f"a mesh of {n} data rows trains one process per row: "
                "join them with core.mesh.init_distributed, or run "
                "train-detector --mesh")
        if dist.get_world_size() != n:
            raise ValueError(f"{dist.get_world_size()} ranks for a mesh "
                             f"of {n} data-axis entries")
        return dist.group.WORLD, local_batch_slice(batch_size, self.mesh)

    def _put(self, imgs: np.ndarray, targets: Dict[str, np.ndarray]):
        dev = self.device
        return torch.from_numpy(imgs).to(dev), {
            k: torch.from_numpy(v).to(dev) for k, v in targets.items()
        }

    # ------------------------------------------------------------------
    def train(
        self,
        model: torch.nn.Module,
        train_data: TextDetectionDataset,
        val_data: TextDetectionDataset,
    ) -> Dict[str, Any]:
        """Train ``model`` (weights drawn from ``seed``, as the reference
        draws its) -> {status, best_model_path, best_val_loss,
        epochs_trained, history}, or {status: failed, error}."""
        cfg = self.config
        try:
            batch_size = int(cfg.get("batch_size", 8))
            group, (start, size) = self._data_parallel(batch_size)
            rows = slice(start, start + size)
            writer = group is None or dist.get_rank() == 0
            row = self._row()
            state = create_train_state(
                model,
                learning_rate=float(cfg.get("learning_rate", 1e-4)),
                weight_decay=float(cfg.get("weight_decay", 1e-5)),
                seed=int(cfg.get("seed", 0)),
                device=self.device,
                row=row,
            )
            optimizer = state["optimizer"]
            train_step = make_train_step(model, optimizer, group)
            eval_step = make_eval_step(model, group)

            ckpt_dir = Path(cfg.get("checkpoint_dir", "./checkpoints"))
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            max_epochs = int(cfg.get("max_epochs", 10))
            es_patience = int(cfg.get("early_stop_patience", 10))
            pl_patience = int(cfg.get("plateau_patience", 5))
            pl_factor = float(cfg.get("plateau_factor", 0.5))
            top_k = int(cfg.get("save_top_k", 3))

            best_val = float("inf")
            best_path = ""
            epochs_no_improve = 0
            plateau_count = 0
            saved: List[Tuple[float, str]] = []
            history: List[Dict[str, float]] = []
            epoch = 0

            for epoch in range(max_epochs):
                t0 = time.time()
                train_losses = []
                for imgs, targets in train_data.batches(
                    batch_size, shuffle=True, seed=epoch
                ):
                    aux = train_step(*self._put(
                        imgs[rows], {k: v[rows] for k, v in targets.items()}))
                    train_losses.append(float(aux["loss"]))

                val = self._evaluate_epoch(eval_step, val_data, batch_size,
                                           rows, group)
                history.append(
                    {
                        "epoch": epoch,
                        "train_loss": float(np.mean(train_losses)),
                        "epoch_seconds": time.time() - t0,
                        **val,
                    }
                )
                logger.info("epoch %d: %s", epoch, history[-1])

                # plateau rule
                if val["val_loss"] < best_val - 1e-6:
                    plateau_count = 0
                else:
                    plateau_count += 1
                    if plateau_count > pl_patience:
                        for group in optimizer.param_groups:
                            group["lr"] = group["lr"] * pl_factor
                        plateau_count = 0

                # top-k checkpoints by val_loss
                # (rank 0 writes; every rank keeps the same list)
                if len(saved) < top_k or val["val_loss"] < saved[-1][0]:
                    path = ckpt_dir / f"epoch{epoch}-val{val['val_loss']:.4f}.pt"
                    if writer:
                        save_state_dict(path, model)
                    saved.append((val["val_loss"], str(path)))
                    saved.sort(key=lambda t: t[0])
                    for _, stale in saved[top_k:]:
                        if writer:
                            Path(stale).unlink(missing_ok=True)
                    saved = saved[:top_k]

                # early stopping
                if val["val_loss"] < best_val - 1e-6:
                    best_val = val["val_loss"]
                    best_path = saved[0][1]
                    epochs_no_improve = 0
                else:
                    epochs_no_improve += 1
                    if epochs_no_improve >= es_patience:
                        break

            return {
                "status": "success",
                "best_model_path": best_path or (saved[0][1] if saved else ""),
                "best_val_loss": float(best_val),
                "epochs_trained": epoch + 1,
                "history": history,
            }
        except Exception as e:
            logger.error("Training failed: %s", e)
            return {"status": "failed", "error": str(e)}

    # ------------------------------------------------------------------
    def _evaluate_epoch(
        self, eval_step, data: TextDetectionDataset, batch_size: int,
        rows: slice = slice(None), group=None,
    ) -> Dict[str, float]:
        """Loss, precision, recall and F1 over ``data``; under ``group``
        this rank feeds its ``rows`` of each batch, the sums are global,
        and every rank takes rank 0's numbers (the same decisions
        everywhere)."""
        losses, tp, fp, fn = [], 0.0, 0.0, 0.0
        for imgs, targets, valid in data.batches(batch_size, with_valid=True):
            aux = eval_step(
                *self._put(imgs[rows], {k: v[rows] for k, v in
                                        targets.items()}),
                torch.from_numpy(valid[rows]).to(self.device),
            )
            # the running loss mean weighted by each batch's real samples
            losses.extend([float(aux["loss"])] * int(valid.sum()))
            tp += float(aux["tp"])
            fp += float(aux["fp"])
            fn += float(aux["fn"])
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if precision + recall > 0
            else 0.0
        )
        val = {
            "val_loss": float(np.mean(losses)) if losses else 0.0,
            "val_precision": precision,
            "val_recall": recall,
            "val_f1": f1,
        }
        if group is not None:
            t = torch.tensor(list(val.values()), dtype=torch.float64,
                             device=self.device)
            dist.broadcast(t, 0, group=group)
            val = dict(zip(val, t.tolist()))
        return val

    # ------------------------------------------------------------------
    def evaluate(
        self, model: torch.nn.Module, test_data: TextDetectionDataset,
        variables: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, float]:
        """Metrics of ``model`` with ``variables`` (a port state dict, such
        as a checkpoint's) or, without them, with weights drawn from seed
        0, as the reference evaluates a fresh state."""
        if variables is None:
            seeded_init_(model, 0)
        else:
            model.load_state_dict(variables)
        tensor_parallel_(model, self._row() or [self.device])
        batch_size = int(self.config.get("batch_size", 8))
        group, (start, size) = self._data_parallel(batch_size)
        return self._evaluate_epoch(make_eval_step(model, group), test_data,
                                    batch_size, slice(start, start + size),
                                    group)
