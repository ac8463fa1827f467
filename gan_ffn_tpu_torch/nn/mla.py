"""Multi-head latent attention (DeepSeek-V3's ``DeepseekV3Attention``,
without a query LoRA, as Moonlight-16B-A3B runs it), causal over a
dialogue's utterances.

From the hidden state ``h (L, B, D)``:

- ``q = h Wq^T`` gives each head ``qk_nope + qk_rope`` columns;
- ``[c_kv, k_pe] = h Wkva^T``: the ``kv_rank``-wide latent and one rotary
  key of ``qk_rope`` that every head shares;
- ``[k_nope, v] = RMSNorm(c_kv) Wkvb^T``: ``qk_nope + v_dim`` a head;
- RoPE (theta ``rope_theta``, positions 0..L-1) on ``q_pe`` and ``k_pe``
  after the V3 code's de-interleave of their columns;
- softmax attention of ``[q_nope, q_pe]`` on ``[k_nope, k_pe]`` at scale
  ``(qk_nope + qk_rope)^-1/2``, each query over the keys at or before it
  and below ``valid_len``; ``o_proj`` of the heads' outputs.

No biases, no dropout.  The projections are float32 ``F.linear`` and the
attention core float32 batched products with a masked softmax (with TF32
off, as the runtime sets it): heads of 192 and 128 columns, which the
port's attention kernels (equal q, k, v widths of at most 64) do not take.
Where the port's tracing is on, the forward is the region ``gan_ffn.mla``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..utils import profiling
from .core import Linear, RMSNorm

MLA = "gan_ffn.mla"
NEG_INF = -1e30


def rope_tables(L: int, dim: int, theta: float, device) -> tuple:
    """``(cos, sin)`` of shape ``(L, dim)``: V3's rotary embedding at
    positions 0..L-1 (frequencies ``theta^(-2i/dim)``, each used twice)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                                / dim))
    freqs = torch.outer(torch.arange(L, dtype=torch.float32, device=device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """V3's ``apply_rotary_pos_emb`` on ``x (L, ..., dim)``: the columns
    de-interleaved (evens, then odds), then rotated by half."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    return x * cos.view(shape) + rot * sin.view(shape)


def causal_key_mask(L: int, valid_len, device) -> torch.Tensor:
    """(L, L) True where query i may not see key j: j > i or j >= valid_len."""
    keys = torch.arange(L, device=device)
    return (keys[None, :] > keys[:, None]) | (keys[None, :] >= valid_len)


class LatentAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, qk_nope: int, qk_rope: int, v_dim: int,
                 kv_rank: int, rope_theta: float, eps: float, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.heads, self.qk_nope, self.qk_rope, self.v_dim = heads, qk_nope, qk_rope, v_dim
        self.kv_rank, self.rope_theta = kv_rank, rope_theta
        kw = dict(bias=False, generator=generator, device=device)
        self.q_proj = Linear(hidden, heads * (qk_nope + qk_rope), **kw)
        self.kv_a_proj_with_mqa = Linear(hidden, kv_rank + qk_rope, **kw)
        self.kv_a_layernorm = RMSNorm(kv_rank, eps, device=device)
        self.kv_b_proj = Linear(kv_rank, heads * (qk_nope + v_dim), **kw)
        self.o_proj = Linear(heads * v_dim, hidden, **kw)

    def forward(self, h: torch.Tensor, valid_len) -> torch.Tensor:
        with profiling.region(MLA, h.device):
            return self._forward(h, valid_len)

    def _forward(self, h: torch.Tensor, valid_len) -> torch.Tensor:
        L, B, _ = h.shape
        nh, dn, dr, dv = self.heads, self.qk_nope, self.qk_rope, self.v_dim
        q = self.q_proj(h).view(L, B, nh, dn + dr)
        c_kv, k_pe = self.kv_a_proj_with_mqa(h).split([self.kv_rank, dr], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv)).view(L, B, nh, dn + dv)
        k_nope, v = kv.split([dn, dv], dim=-1)
        cos, sin = rope_tables(L, dr, self.rope_theta, h.device)
        q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], cos, sin)], dim=-1)
        k_pe = apply_rope(k_pe.view(L, B, 1, dr), cos, sin).expand(L, B, nh, dr)
        k = torch.cat([k_nope, k_pe], dim=-1)
        q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))  # (B, nh, L, d)
        scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(dn + dr))
        p = torch.softmax(scores.masked_fill(causal_key_mask(L, valid_len, h.device), NEG_INF),
                          dim=-1)
        out = torch.matmul(p, v).permute(2, 0, 1, 3).reshape(L, B, nh * dv)
        return self.o_proj(out)
