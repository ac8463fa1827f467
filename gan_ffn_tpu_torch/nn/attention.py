"""The DialogueRNN's attentions (counterpart of
``gan_ffn_tpu/nn/attention.py``; reference model.py:22-194).

- ``SimpleAttention``: a scalar projection, softmax over the sequence axis,
  a weighted sum; alpha stays float32.
- ``MatchingAttention``: memory-candidate attention with the reference's
  four score types: ``dot``, ``general``, ``general2`` (tanh of the masked
  scores, softmax, the mask applied again and the weights renormalised,
  where a fully masked row divides by 1 and gives 0, not NaN) and
  ``concat``.  Queries may carry a leading time axis, so BiModel's att2
  attends over all L queries in one call.

Each computes at the memory's dtype (bf16 under ``--bf16``), its float32
weights cast at use, the softmax in float32, as the JAX modules do.
Masked positions (``mask == 0``) get the score -1e30 before the softmax,
the JAX package's fixed-buffer semantics.  Both modules are thin layouts
over :func:`simple_attention` and :func:`matching_attention`, which take
their weights with a leading axis: the DialogueRNN scan runs both
directions' context attentions through them as one batch of products
(``models/dialogue_rnn.py``).  ``Attention`` and ``matching`` come with the
MELD slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .core import Linear
from .recurrent import stacked_linear

NEG_INF = -1e30
ATT_TYPES = ("dot", "general", "general2", "concat")


def _masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Float32 softmax over the last axis; ``mask (X, B, L)`` against scores
    ``(X, B, T, L)``."""
    scores = scores.float()
    if mask is not None:
        scores = scores.masked_fill(mask.unsqueeze(2) <= 0, NEG_INF)
    return torch.softmax(scores, dim=-1)


def simple_attention(M: torch.Tensor, weight: torch.Tensor,
                     mask: Optional[torch.Tensor] = None):
    """``M (X, B, L, D)``, ``weight (X, 1, D)``, ``mask (X, B, L)`` or None
    -> ``pool (X, B, D)``, ``alpha (X, B, L)`` float32."""
    scores = (M @ weight.to(M.dtype).transpose(1, 2).unsqueeze(1)).squeeze(-1)  # (X, B, L)
    alpha = _masked_softmax(scores.unsqueeze(2), mask).squeeze(2)
    pool = (alpha.to(M.dtype).unsqueeze(2) @ M).squeeze(2)
    return pool, alpha


def matching_attention(att_type: str, M: torch.Tensor, x: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       transform_weight: Optional[torch.Tensor] = None,
                       transform_bias: Optional[torch.Tensor] = None,
                       vector_weight: Optional[torch.Tensor] = None):
    """``M (X, B, L, D_mem)``, queries ``x (X, B, T, D_cand)``, ``mask (X,
    B, L)`` or None (every position valid) -> ``pool (X, B, T, D_mem)``,
    ``alpha (X, B, T, L)``.  Weights ``(X, out, in)``, biases ``(X, out)``:
    ``transform`` for all types but ``dot`` (its bias for ``general2``
    only), ``vector_prod`` for ``concat``."""
    if att_type == "dot":
        alpha = _masked_softmax(x @ M.transpose(-1, -2), mask)
    elif att_type == "general":
        xt = stacked_linear(x, transform_weight)
        alpha = _masked_softmax(xt @ M.transpose(-1, -2), mask)
    elif att_type == "general2":
        xt = stacked_linear(x, transform_weight, transform_bias)
        if mask is None:
            alpha = torch.softmax(torch.tanh(xt @ M.transpose(-1, -2)).float(), dim=-1)
        else:
            m = mask.unsqueeze(2)  # (X, B, 1, L)
            Mm = M * mask.unsqueeze(-1)  # at the promoted dtype, as JAX multiplies them
            scores = torch.tanh((xt.to(Mm.dtype) @ Mm.transpose(-1, -2)) * m)
            alpha = torch.softmax(scores.float(), dim=-1) * m
            # a fully masked row sums to 0: divide it by 1, so it stays 0
            denom = alpha.sum(-1, keepdim=True)
            alpha = alpha / torch.where(denom > 0, denom, torch.ones_like(denom))
    elif att_type == "concat":
        X, B, T, _ = x.shape
        L = M.shape[2]
        mx = torch.cat([M.unsqueeze(2).expand(X, B, T, L, M.shape[-1]),
                        x.unsqueeze(3).expand(X, B, T, L, x.shape[-1])], dim=-1)
        scores = stacked_linear(torch.tanh(stacked_linear(mx, transform_weight)), vector_weight)
        alpha = _masked_softmax(scores.squeeze(-1), mask)
    else:
        raise ValueError(f"unknown att_type {att_type!r}")
    alpha = alpha.to(M.dtype)
    return alpha @ M, alpha


class SimpleAttention(nn.Module):
    """``M (L, B, D)``, ``mask (B, L)`` or None -> ``pool (B, D)``, ``alpha
    (B, 1, L)`` float32."""

    def __init__(self, input_dim: int, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.scalar = Linear(input_dim, 1, bias=False, generator=generator, device=device)

    def forward(self, M: torch.Tensor, x: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
        pool, alpha = simple_attention(M.transpose(0, 1)[None], self.scalar.weight[None],
                                       None if mask is None else mask[None])
        return pool[0], alpha[0].unsqueeze(1)


class MatchingAttention(nn.Module):
    """``M (L, B, mem_dim)``, ``x (B, cand_dim)`` or ``(T, B, cand_dim)``,
    ``mask (B, L)`` or None -> ``pool (B, mem_dim)`` or ``(T, B, mem_dim)``
    and ``alpha (B, 1, L)`` or ``(T, B, 1, L)``.

    Init as the reference's: ``general2``'s ``transform`` weight N(0, 0.01)
    with torch's default bias, every other weight torch's default."""

    def __init__(self, mem_dim: int, cand_dim: int, alpha_dim: Optional[int] = None,
                 att_type: str = "general2", *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if att_type not in ATT_TYPES:
            raise ValueError(f"unknown att_type {att_type!r}")
        if att_type == "dot" and mem_dim != cand_dim:
            raise ValueError("att_type 'dot' needs mem_dim == cand_dim")
        if att_type == "concat" and alpha_dim is None:
            raise ValueError("att_type 'concat' needs alpha_dim")
        self.att_type = att_type
        kw = dict(generator=generator, device=device)
        if att_type in ("general", "general2"):
            self.transform = Linear(cand_dim, mem_dim, bias=att_type == "general2", **kw)
            if att_type == "general2":
                with torch.no_grad():
                    w = torch.empty(mem_dim, cand_dim).normal_(0.0, 0.01, generator=generator)
                    self.transform.weight.copy_(w)
        elif att_type == "concat":
            self.transform = Linear(cand_dim + mem_dim, alpha_dim, bias=False, **kw)
            self.vector_prod = Linear(alpha_dim, 1, bias=False, **kw)

    def weights(self):
        """``(transform weight, transform bias, vector_prod weight)``, None
        where the type has none: :func:`matching_attention`'s last three
        arguments, without the leading axis."""
        transform = getattr(self, "transform", None)
        vector = getattr(self, "vector_prod", None)
        return (None if transform is None else transform.weight,
                None if transform is None else transform.bias,
                None if vector is None else vector.weight)

    def forward(self, M: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        single = x.dim() == 2
        queries = x.unsqueeze(1) if single else x.transpose(0, 1)  # (B, T, cand)
        pool, alpha = matching_attention(
            self.att_type, M.transpose(0, 1)[None], queries[None],
            None if mask is None else mask[None],
            *(None if w is None else w[None] for w in self.weights()))
        if single:
            return pool[0, :, 0], alpha[0]
        return pool[0].transpose(0, 1), alpha[0].transpose(0, 1).unsqueeze(2)
