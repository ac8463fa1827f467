"""Masked losses (counterpart of ``gan_ffn_tpu/nn/losses.py``; reference
model.py:62-81 and train_IEMOCAP.py:341-346).

``masked_nll_loss`` keeps MaskedNLLLoss's quirks: the log-probabilities are
multiplied by the mask BEFORE the NLL gather, and the weighted variant
normalises by ``sum(weight[target] * mask)``.

``bce_loss`` is stage A's ``nn.BCELoss``.  At float32 ATen's kernel already
has the two behaviours the JAX package rebuilds by hand: the log clamped at
-100 in the forward, and the backward ``(p - t) / clamp_min(p (1 - p),
1e-12)``, which keeps the gradient finite where a sigmoid saturates to
exactly 0 or 1.  At bf16 (the discriminators' output under ``--bf16``) the
JAX package runs that pair op by op at the prediction's dtype, each op
rounded to it (``gan_ffn_tpu/nn/losses.py:110-131``), where ATen's kernel
would compute in f32 and round once; :class:`_ElementBCE` runs the same ops.
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


class _ElementBCE(torch.autograd.Function):
    """Per-element BCE as ``gan_ffn_tpu/nn/losses.py::_bce_elem`` computes it,
    every op at ``pred``'s dtype: forward ``-(t max(log p, -100) + (1 - t)
    max(log(1 - p), -100))``, backward ``g (p - t) / max(p (1 - p), 1e-12)``
    for the prediction (the target takes no gradient: it is a constant at
    every call site)."""

    @staticmethod
    def forward(ctx, pred, target):
        ctx.save_for_backward(pred, target)
        log_p = torch.clamp_min(torch.log(pred), -100.0)
        log_1mp = torch.clamp_min(torch.log(1.0 - pred), -100.0)
        return -(target * log_p + (1.0 - target) * log_1mp)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        denom = torch.clamp_min(pred * (1.0 - pred), 1e-12)
        return g * (pred - target) / denom, None


def bce_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Binary cross-entropy, mean over every element, or with ``mask`` (any
    shape that broadcasts to ``pred``) over the masked-in elements only:
    ``sum(bce * m) / sum(m)``.  Returns a 0-d tensor."""
    if pred.dtype == torch.float32:
        elem = F.binary_cross_entropy(pred, target, reduction="none")
    else:
        elem = _ElementBCE.apply(pred, target.to(pred.dtype))
    if mask is None:
        return elem.mean()
    m = mask.to(elem.dtype).expand_as(elem)
    return (elem * m).sum() / m.sum()
