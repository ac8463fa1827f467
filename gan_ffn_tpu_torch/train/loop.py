"""Epoch loop (counterpart of ``gan_ffn_tpu/train/loop.py``; reference
train_or_eval_model, train_IEMOCAP.py:103-197).

Per epoch it returns the reference's tuple as an :class:`EpochResult`:
the mask-weighted average loss ``sum_b(loss_b * mask_sum_b) /
sum_b(mask_sum_b)``, the accuracy, labels, predictions, masks and the
weighted F1, and, for an eval step that returns attention weights, those
(the reference's seventh return).  Losses, predictions and attention
weights stay on the device until the epoch ends and come back in one
device-to-host copy, so no batch waits on the host (the reference copies
after every batch).
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
    # An eval epoch's attention weights where the step returns them (the
    # reference's ``attentions = [alphas, alphas_f, alphas_b, vids]``,
    # train_IEMOCAP_DialogueRNN.py:120,173-176): each key (``alpha``,
    # ``alpha_f``, ``alpha_b``) maps to a list of per-batch arrays whose
    # batch axis (axis 1) is cut to the batch's ``n_real`` real dialogues,
    # and ``vids`` to the per-batch lists of dialogue ids, so
    # ``attentions[key][i][:, j]`` pairs with ``attentions["vids"][i][j]``.
    # None for train epochs and for steps without attention weights.
    attentions: Optional[Dict[str, list]] = None


def run_epoch(
    loader: Iterable[Batch],
    step: Callable,
    device,
    lr_scale: Optional[float] = None,
) -> EpochResult:
    """One epoch of ``step`` (a ``train_step`` or an ``eval_step`` of
    ``train.classifier.make_classifier_steps``) over ``loader``.
    ``lr_scale`` is handed to a train step; None leaves its default.  An
    eval step that returns ``(loss, preds, attentions)`` fills
    ``EpochResult.attentions``."""
    losses, preds, mask_sums, labels, masks = [], [], [], [], []
    attns, vids = [], []  # per batch: {key: (L, n_real, L) tensor}, dialogue ids
    for batch in loader:
        tensors = batch_to_tensors(batch, device)
        out = step(tensors) if lr_scale is None else step(tensors, lr_scale)
        losses.append(out[0])
        preds.append(out[1])
        if len(out) == 3:
            attns.append({k: a[:, :batch.n_real] for k, a in out[2].items() if a is not None})
            vids.append(list(batch.vids))
        mask_flat = batch.umask.reshape(-1)
        mask_sums.append(mask_flat.sum())
        labels.append(batch.label.reshape(-1))
        masks.append(mask_flat)
    if not losses:
        empty = np.array([])
        return EpochResult(float("nan"), float("nan"), empty, empty, empty, float("nan"))

    # one device-to-host copy for the epoch: losses, predictions, attentions
    pieces = [torch.stack(losses).float()] + [p.float() for p in preds]
    pieces += [a.float().reshape(-1) for batch_attns in attns for a in batch_attns.values()]
    flat = torch.cat(pieces).cpu().numpy()
    n = len(losses)
    n_preds = sum(p.numel() for p in preds)
    batch_losses, preds_np = flat[:n], flat[n:n + n_preds].astype(np.int64)
    attentions = None
    if attns:
        attentions = {"vids": vids}
        offset = n + n_preds
        for batch_attns in attns:
            for k, a in batch_attns.items():
                attentions.setdefault(k, []).append(
                    flat[offset:offset + a.numel()].reshape(a.shape))
                offset += a.numel()
    labels_np, masks_np = np.concatenate(labels), np.concatenate(masks)
    weighted = [float(l) * s for l, s in zip(batch_losses, mask_sums)]
    avg_loss = round(float(np.sum(weighted) / np.sum(masks_np)), 4)
    avg_acc = round(accuracy_score(labels_np, preds_np, sample_weight=masks_np) * 100, 2)
    avg_f1 = round(
        f1_score(labels_np, preds_np, sample_weight=masks_np, average="weighted") * 100, 2
    )
    return EpochResult(avg_loss, avg_acc, labels_np, preds_np, masks_np, avg_f1, attentions)
