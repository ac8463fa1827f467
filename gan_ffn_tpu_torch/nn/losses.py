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

Both take an optional ``denominator``: the whole batch's ``sum(w * mask)``
or ``sum(mask)`` (:func:`nll_denominator`, :func:`bce_denominator`), which a
data-parallel rank computes from the whole batch it loaded
(``parallel/mesh.py``).  Its loss is then its own numerator over the global
denominator, so the ranks' losses and gradients sum to the single-process
ones, and a rank whose slice is all padding gives 0, not 0 / 0.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def nll_denominator(
    target: torch.Tensor,
    mask: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The denominator of :func:`masked_nll_loss` at ``dtype`` (the
    log-probabilities'): ``sum(weight[target] * mask)``, or ``sum(mask)``."""
    mask_flat = mask.reshape(-1).to(dtype)
    if weight is None:
        return mask_flat.sum()
    return (weight.to(dtype)[target.reshape(-1).long()] * mask_flat).sum()


def masked_nll_loss(
    log_probs: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    denominator: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MaskedNLLLoss: log_probs (N, C); target (N,) int; mask any shape with
    N elements; weight optional (C,); ``denominator`` the whole batch's
    :func:`nll_denominator` (default: this batch's).  Returns a 0-d tensor."""
    mask_flat = mask.reshape(-1).to(log_probs.dtype)
    target = target.reshape(-1).long()
    picked = log_probs.gather(1, target[:, None])[:, 0] * mask_flat
    if denominator is None:
        denominator = nll_denominator(target, mask, weight, log_probs.dtype)
    if weight is None:
        return -picked.sum() / denominator
    w = weight.to(log_probs.dtype)[target]
    return -(w * picked).sum() / denominator


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


def bce_denominator(mask: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    """The denominator of :func:`bce_loss` at ``dtype`` (the prediction's)
    for a ``mask`` broadcast to a prediction of ``shape``: ``sum(m)``."""
    return mask.to(dtype).expand(shape).sum()


def bce_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    denominator: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Binary cross-entropy, mean over every element, or with ``mask`` (any
    shape that broadcasts to ``pred``) over the masked-in elements only:
    ``sum(bce * m) / sum(m)``, where ``denominator`` (default: this batch's
    :func:`bce_denominator`) may be the whole batch's.  Returns a 0-d
    tensor."""
    if pred.dtype == torch.float32:
        elem = F.binary_cross_entropy(pred, target, reduction="none")
    else:
        elem = _ElementBCE.apply(pred, target.to(pred.dtype))
    if mask is None:
        return elem.mean()
    m = mask.to(elem.dtype).expand_as(elem)
    if denominator is None:
        denominator = bce_denominator(mask, elem.shape, elem.dtype)
    return (elem * m).sum() / denominator
