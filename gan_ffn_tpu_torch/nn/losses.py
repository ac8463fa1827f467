"""Masked losses (counterpart of ``gan_ffn_tpu/nn/losses.py``; reference
model.py:62-81).  Stage A's ``bce_loss`` comes with stage A.

``masked_nll_loss`` keeps MaskedNLLLoss's quirks: the log-probabilities are
multiplied by the mask BEFORE the NLL gather, and the weighted variant
normalises by ``sum(weight[target] * mask)``.
"""

from __future__ import annotations

from typing import Optional

import torch


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
