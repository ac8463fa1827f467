"""The attentions of the DialogueRNN and of the baselines (counterpart of
``gan_ffn_tpu/nn/attention.py``; reference model.py:22-298).

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
(``models/dialogue_rnn.py``); ``MELDLSTMModel`` runs ``general2`` over all
L queries in one call.

- ``Attention``: the reference's multi-head attention (model.py:197-286)
  with its quirks: the softmax runs over axis 0 of the ``(n_head * batch,
  q_len, k_len)`` scores (the head-times-batch axis, not the keys), the
  output is formed from the keys' projection ``kx`` (there is no value
  projection), a 2-D input gets a length axis of 1, and the ``mlp`` and
  ``bi_linear`` scores have their own ``weight``.  It is not the fused
  attention of ``ops/attention.py``: its softmax axis differs.
- ``matching``: the cross-modal matching helper (model.py:289-298), a
  ``MatchingAttention`` of every step of ``modal`` over ``emotions`` plus
  ``gelu(emotions)``.

These two serve the library-only baselines (``models/baselines.py``).
"""

from __future__ import annotations

from typing import Optional

import math

import torch
import torch.nn.functional as F
from torch import nn

from .core import Linear, gelu, uniform_parameter
from .recurrent import stacked_linear

NEG_INF = -1e30
ATT_TYPES = ("dot", "general", "general2", "concat")
SCORE_FUNCTIONS = ("dot_product", "scaled_dot_product", "mlp", "bi_linear")


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


class Attention(nn.Module):
    """The reference's multi-head ``Attention`` (model.py:197-286): ``k (B,
    k_len, embed_dim)``, ``q (B, q_len, embed_dim)`` (2-D: a length of 1)
    -> ``(output (B, q_len, out_dim), score (n_head * B, q_len, k_len))``,
    batch-first.  ``w_k`` and ``w_q`` project to ``n_head * hidden_dim``
    (``hidden_dim`` default ``embed_dim // n_head``), ``proj`` to ``out_dim``
    (default ``embed_dim``); the score is ``score_function`` of the heads'
    ``qx`` and ``kx``, softmaxed in float32 over axis 0; the output is
    ``score kx`` with the heads concatenated, through ``proj``, then
    dropout (``F.dropout``, torch's RNG) in training mode."""

    def __init__(self, embed_dim: int, hidden_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, n_head: int = 4,
                 score_function: str = "scaled_dot_product", dropout: float = 0.6, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if score_function not in SCORE_FUNCTIONS:
            raise ValueError(f"invalid score_function {score_function!r}")
        self.hidden_dim = hidden_dim or embed_dim // n_head
        self.out_dim = out_dim or embed_dim
        self.n_head, self.score_function, self.dropout = n_head, score_function, dropout
        kw = dict(generator=generator, device=device)
        self.w_k = Linear(embed_dim, n_head * self.hidden_dim, **kw)
        self.w_q = Linear(embed_dim, n_head * self.hidden_dim, **kw)
        self.proj = Linear(n_head * self.hidden_dim, self.out_dim, **kw)
        bound = 1.0 / math.sqrt(self.hidden_dim)
        if score_function == "mlp":
            self.weight = uniform_parameter((2 * self.hidden_dim,), bound, generator, device)
        elif score_function == "bi_linear":
            self.weight = uniform_parameter((self.hidden_dim, self.hidden_dim), bound, generator,
                                            device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, n, H * Dh)`` -> ``(H * B, n, Dh)``, the reference's permute and view."""
        B, n, _ = x.shape
        H, Dh = self.n_head, self.hidden_dim
        return x.reshape(B, n, H, Dh).permute(2, 0, 1, 3).reshape(H * B, n, Dh)

    def forward(self, k: torch.Tensor, q: torch.Tensor):
        if q.dim() == 2:
            q = q.unsqueeze(1)
        if k.dim() == 2:
            k = k.unsqueeze(1)
        B, k_len, q_len = k.shape[0], k.shape[1], q.shape[1]
        kx, qx = self._heads(self.w_k(k)), self._heads(self.w_q(q))
        if self.score_function == "dot_product":
            score = qx @ kx.transpose(1, 2)
        elif self.score_function == "scaled_dot_product":
            score = (qx @ kx.transpose(1, 2)) / math.sqrt(self.hidden_dim)
        elif self.score_function == "mlp":
            shape = (kx.shape[0], q_len, k_len, self.hidden_dim)
            kq = torch.cat([kx.unsqueeze(1).expand(shape), qx.unsqueeze(2).expand(shape)], dim=-1)
            score = torch.tanh(kq @ self.weight.to(kx.dtype))
        else:  # bi_linear
            score = (qx @ self.weight.to(qx.dtype)) @ kx.transpose(1, 2)
        score = torch.softmax(score.float(), dim=0).to(kx.dtype)  # the reference's dim=0
        output = score @ kx  # (H * B, q_len, Dh)
        output = output.reshape(self.n_head, B, q_len, self.hidden_dim).permute(1, 2, 0, 3)
        output = self.proj(output.reshape(B, q_len, self.n_head * self.hidden_dim))
        return F.dropout(output, self.dropout, self.training), score


def matching(matchatt, emotions: torch.Tensor, modal: torch.Tensor, umask: torch.Tensor):
    """The cross-modal matching of the reference (model.py:289-298):
    ``matchatt(emotions, modal, umask)`` (a ``MatchingAttention``, every step
    of ``modal (T, B, cand)`` a query over ``emotions (L, B, mem)``) plus
    ``gelu(emotions)``: ``(hidden (T, B, mem), alpha (T, B, 1, L))``."""
    att_emotions, alpha = matchatt(emotions, modal, umask)
    return att_emotions + gelu(emotions), alpha
