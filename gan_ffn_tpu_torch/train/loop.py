"""Epoch loops (counterpart of ``gan_ffn_tpu/train/loop.py``; reference
train_or_eval_model, train_IEMOCAP.py:103-197).

Per epoch they return the reference's tuple as an :class:`EpochResult`:
the mask-weighted average loss ``sum_b(loss_b * mask_sum_b) /
sum_b(mask_sum_b)``, the accuracy, labels, predictions, masks and the
weighted F1, and, for an eval step that returns attention weights, those
(the reference's seventh return).  Losses, predictions and attention
weights stay on the device until the epoch ends and come back in one
device-to-host copy, so no batch waits on the host (the reference copies
after every batch).

:func:`run_epoch` runs one step per batch in loader order;
:func:`run_epoch_fused` is the epoch-fused counterpart (``--epoch-fused``),
over the steps of ``train.classifier.make_classifier_epoch_steps``, which
replay one CUDA graph per batch shape on a card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.loaders import Batch
from ..evaluation.metrics import accuracy_score, f1_score
from ..ops.dropout import StepSeeds, host_to_device

_ARRAYS = ("text", "audio", "visual", "qmask", "umask", "label")


def batch_to_tensors(batch: Batch, device, seed: Optional[int] = None) -> Dict[str, object]:
    """A host :class:`Batch` as tensors on ``device`` (copied through pinned
    memory on a card, without waiting): the arrays; ``valid_len`` (the
    longest dialogue of the batch) and ``n_real`` as 0-d int32 tensors,
    which the steps read on the device, and beside them the same as host
    ints, ``host_valid_len`` and ``host_n_real``; with ``seed``, a train
    step's dropout seed base as the 0-d int64 ``seed``."""
    L, B = batch.umask.shape[1], batch.umask.shape[0]
    valid_len, n_real = int(batch.umask.sum(axis=1).max()), int(batch.n_real)
    if not (0 <= valid_len <= L and 0 <= n_real <= B):
        raise ValueError(f"a batch of L={L}, B={B} has valid_len {valid_len}, n_real {n_real}")
    out: Dict[str, object] = {
        "text": torch.from_numpy(batch.text),
        "audio": torch.from_numpy(batch.audio),
        "qmask": torch.from_numpy(batch.qmask),
        "umask": torch.from_numpy(batch.umask),
        "label": torch.from_numpy(batch.label.astype(np.int64)),
        "valid_len": torch.tensor(valid_len, dtype=torch.int32),
        "n_real": torch.tensor(n_real, dtype=torch.int32),
    }
    if batch.visual is not None:
        out["visual"] = torch.from_numpy(batch.visual)
    if seed is not None:
        out["seed"] = torch.tensor(seed, dtype=torch.int64)
    out = {k: host_to_device(v, device) for k, v in out.items()}
    out["host_valid_len"], out["host_n_real"] = valid_len, n_real
    return out


def batch_signature(batch: Batch) -> tuple:
    """The shapes that decide a batch's graph: its arrays'."""
    return tuple((k, getattr(batch, k).shape) for k in _ARRAYS if getattr(batch, k) is not None)


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
    ``lr_scale`` is handed to a train step; None leaves its lr.  An eval
    step that returns ``(loss, preds, attentions)`` fills
    ``EpochResult.attentions``.  A train step draws its dropout seed base
    itself, in loader order."""
    batches, outs = [], []
    for batch in loader:
        tensors = batch_to_tensors(batch, device)
        outs.append(step(tensors) if lr_scale is None else step(tensors, lr_scale))
        batches.append(batch)
    return epoch_result(batches, outs)


def run_epoch_fused(
    loader: Iterable[Batch],
    step: Callable,
    device,
    lr_scale: Optional[float] = None,
) -> EpochResult:
    """Epoch-fused counterpart of :func:`run_epoch` (of
    ``gan_ffn_tpu/train/loop.py::run_epoch_fused``), over a step of
    ``train.classifier.make_classifier_epoch_steps``: on a card one CUDA
    graph per batch shape, captured at the shape's first batch and replayed
    for the others; on the CPU the same steps run eagerly.

    Semantics, as the JAX package's: batches are grouped by shape, the
    groups run in order of first appearance and each keeps loader order;
    every batch gets the dropout seed base that the per-batch loop would
    have drawn for it (all are drawn first, in loader order, from the step's
    ``seeds``); losses, predictions, labels, masks and attentions are
    assembled in loader order.  So a single-shape epoch is the per-batch
    loop, and where an epoch spans several shapes, train updates reorder
    across the groups.  Eval epochs hold no state, so grouping never
    changes their results."""
    batches = list(loader)
    order, bases = fused_order(batches, getattr(step, "seeds", None))
    outs: List[object] = [None] * len(batches)
    for i in order:
        tensors = batch_to_tensors(batches[i], device, seed=bases[i])
        outs[i] = step(tensors) if lr_scale is None else step(tensors, lr_scale)
    return epoch_result(batches, outs)


def fused_order(batches: Sequence[Batch], seeds: Optional[StepSeeds]
                ) -> Tuple[List[int], List[Optional[int]]]:
    """The epoch-fused policy of :func:`run_epoch_fused` and of stage A's
    ``cli.common.train_gan``: ``(order, bases)``, where ``order`` runs the
    batches grouped by :func:`batch_signature`, groups in order of first
    appearance, each in loader order, and ``bases[i]`` is batch ``i``'s
    dropout seed base, drawn from ``seeds`` in loader order before any step
    runs (None without ``seeds``)."""
    bases = [seeds.draw() if seeds is not None else None for _ in batches]
    groups: Dict[tuple, List[int]] = {}
    for i, batch in enumerate(batches):
        groups.setdefault(batch_signature(batch), []).append(i)
    return [i for idxs in groups.values() for i in idxs], bases


def epoch_result(batches: Sequence[Batch], outs: Sequence[tuple]) -> EpochResult:
    """The :class:`EpochResult` of the steps' outputs ``outs`` (``(loss,
    preds)`` or ``(loss, preds, attentions)``, device tensors) for
    ``batches``, both in loader order: one device-to-host copy."""
    if not outs:
        empty = np.array([])
        return EpochResult(float("nan"), float("nan"), empty, empty, empty, float("nan"))
    losses = [out[0] for out in outs]
    preds = [out[1] for out in outs]
    attns, vids = [], []  # per batch: {key: (L, n_real, L) tensor}, dialogue ids
    for batch, out in zip(batches, outs):
        if len(out) == 3:
            attns.append({k: a[:, :batch.n_real] for k, a in out[2].items() if a is not None})
            vids.append(list(batch.vids))
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
    masks = [batch.umask.reshape(-1) for batch in batches]
    mask_sums = [m.sum() for m in masks]
    labels_np = np.concatenate([batch.label.reshape(-1) for batch in batches])
    masks_np = np.concatenate(masks)
    weighted = [float(l) * s for l, s in zip(batch_losses, mask_sums)]
    avg_loss = round(float(np.sum(weighted) / np.sum(masks_np)), 4)
    avg_acc = round(accuracy_score(labels_np, preds_np, sample_weight=masks_np) * 100, 2)
    avg_f1 = round(
        f1_score(labels_np, preds_np, sample_weight=masks_np, average="weighted") * 100, 2
    )
    return EpochResult(avg_loss, avg_acc, labels_np, preds_np, masks_np, avg_f1, attentions)
