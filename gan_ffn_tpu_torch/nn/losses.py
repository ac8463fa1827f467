"""Masked losses (counterpart of ``gan_ffn_tpu/nn/losses.py``; reference
model.py:62-81 and train_IEMOCAP.py:341-346).

``masked_nll_loss`` keeps MaskedNLLLoss's quirks: the log-probabilities are
multiplied by the mask BEFORE the NLL gather, and the weighted variant
normalises by ``sum(weight[target] * mask)``.

``bce_loss`` is stage A's ``nn.BCELoss``.  ATen's kernel already has the two
behaviours the JAX package rebuilds by hand: the log clamped at -100 in the
forward, and the backward ``(p - t) / clamp_min(p (1 - p), 1e-12)``, which
keeps the gradient finite where a sigmoid saturates to exactly 0 or 1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def masked_nll_loss(
    log_probs: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MaskedNLLLoss: log_probs (N, C); target (N,) int; mask any shape with
    N elements; weight optional (C,).  Returns a 0-d tensor."""
    mask_flat = mask.reshape(-1).to(log_probs.dtype)
    target = target.reshape(-1).long()
    picked = log_probs.gather(1, target[:, None])[:, 0] * mask_flat
    if weight is None:
        return -picked.sum() / mask_flat.sum()
    w = weight.to(log_probs.dtype)[target]
    return -(w * picked).sum() / (w * mask_flat).sum()


def bce_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Binary cross-entropy, mean over every element, or with ``mask`` (any
    shape that broadcasts to ``pred``) over the masked-in elements only:
    ``sum(bce * m) / sum(m)``.  Returns a 0-d tensor."""
    elem = F.binary_cross_entropy(pred, target, reduction="none")
    if mask is None:
        return elem.mean()
    m = mask.to(elem.dtype).expand_as(elem)
    return (elem * m).sum() / m.sum()
