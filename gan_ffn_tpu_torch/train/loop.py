"""Epoch loop (counterpart of ``gan_ffn_tpu/train/loop.py``; reference
train_or_eval_model, train_IEMOCAP.py:103-197).

Per epoch it returns the reference's tuple as an :class:`EpochResult`:
the mask-weighted average loss ``sum_b(loss_b * mask_sum_b) /
sum_b(mask_sum_b)``, the accuracy, labels, predictions, masks and the
weighted F1.  Losses and predictions stay on the device until the epoch
ends and come back in one device-to-host copy, so no batch waits on the
host (the reference copies after every batch).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..data.loaders import Batch
from ..evaluation.metrics import accuracy_score, f1_score


def batch_to_tensors(batch: Batch, device) -> Dict[str, object]:
    """A host :class:`Batch` as tensors on ``device``, with ``valid_len``
    (the longest dialogue of the batch) and ``n_real`` as host ints."""
    out: Dict[str, object] = {
        "text": torch.from_numpy(batch.text).to(device),
        "audio": torch.from_numpy(batch.audio).to(device),
        "qmask": torch.from_numpy(batch.qmask).to(device),
        "umask": torch.from_numpy(batch.umask).to(device),
        "label": torch.from_numpy(batch.label.astype(np.int64)).to(device),
        "valid_len": int(batch.umask.sum(axis=1).max()),
        "n_real": int(batch.n_real),
    }
    if batch.visual is not None:
        out["visual"] = torch.from_numpy(batch.visual).to(device)
    return out


@dataclasses.dataclass
class EpochResult:
    avg_loss: float
    avg_accuracy: float
    labels: np.ndarray
    preds: np.ndarray
    masks: np.ndarray
    avg_fscore: float


def run_epoch(
    loader: Iterable[Batch],
    step: Callable,
    device,
    lr_scale: Optional[float] = None,
) -> EpochResult:
    """One epoch of ``step`` (a ``train_step`` or an ``eval_step`` of
    ``train.classifier.make_classifier_steps``) over ``loader``.
    ``lr_scale`` is handed to a train step; None leaves its default."""
    losses, preds, mask_sums, labels, masks = [], [], [], [], []
    for batch in loader:
        tensors = batch_to_tensors(batch, device)
        loss, pred = step(tensors) if lr_scale is None else step(tensors, lr_scale)
        losses.append(loss)
        preds.append(pred)
        mask_flat = batch.umask.reshape(-1)
        mask_sums.append(mask_flat.sum())
        labels.append(batch.label.reshape(-1))
        masks.append(mask_flat)
    if not losses:
        empty = np.array([])
        return EpochResult(float("nan"), float("nan"), empty, empty, empty, float("nan"))

    # one device-to-host copy for the epoch
    flat = torch.cat([torch.stack(losses).float()] + [p.float() for p in preds]).cpu().numpy()
    n = len(losses)
    batch_losses, preds_np = flat[:n], flat[n:].astype(np.int64)
    labels_np, masks_np = np.concatenate(labels), np.concatenate(masks)
    weighted = [float(l) * s for l, s in zip(batch_losses, mask_sums)]
    avg_loss = round(float(np.sum(weighted) / np.sum(masks_np)), 4)
    avg_acc = round(accuracy_score(labels_np, preds_np, sample_weight=masks_np) * 100, 2)
    avg_f1 = round(
        f1_score(labels_np, preds_np, sample_weight=masks_np, average="weighted") * 100, 2
    )
    return EpochResult(avg_loss, avg_acc, labels_np, preds_np, masks_np, avg_f1)
