"""Post-norm Transformer encoder (counterpart of
``gan_ffn_tpu/nn/transformer.py``, unrolled layout only).

Parameter names and layouts follow ``torch.nn.TransformerEncoderLayer``
(``self_attn.in_proj_weight (3E, E)``, ``self_attn.in_proj_bias``,
``self_attn.out_proj``, ``linear1``, ``linear2``, ``norm1``, ``norm2``,
``layers.{i}``), so ``tests/torch_mapping.py`` maps them to the JAX tree.
Module boundaries are time-major ``(L, B, E)``; heads are ``(B, H, L, Dh)``.

``valid_len`` (a host int or a 0-d int32 tensor on the device) masks
attention keys at positions ``>=`` it, the bucket-padding mask.  The ``in_proj``/``out_proj`` products are plain
``F.linear``, as the JAX package leaves them to XLA; attention runs through
``ops.attention.fused_attention`` and the FFN through ``ops.mlp.fused_mlp``,
which launch the hand-written kernels (forward and backward) on CUDA
tensors.  In training mode the attention-weight and FFN dropouts run inside
those kernels, each call with its seed from the module's ``dropout_seeds``
(``nn.core.kernel_seed``); the two residual dropouts are ``F.dropout`` with
torch's RNG.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention
from ..ops.dropout import StepSeeds
from ..ops.mlp import fused_mlp
from .core import LayerNorm, Linear, kernel_layout, kernel_seed, uniform_parameter


class MultiheadSelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` self-attention, batch_first=False:
    packed xavier-uniform ``in_proj`` with a zero bias, masked softmax
    attention, output projection."""

    dropout_seeds: Optional[StepSeeds] = None  # kernel seeds (nn.core)

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by num_heads {num_heads}")
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        bound = math.sqrt(6.0 / (embed_dim + 3 * embed_dim))  # xavier on (3E, E)
        self.in_proj_weight = uniform_parameter((3 * embed_dim, embed_dim), bound, generator, device)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, device=device))
        self.out_proj = Linear(embed_dim, embed_dim, generator=generator, device=device)

    def forward(self, x: torch.Tensor, valid_len=None) -> torch.Tensor:
        L, B, E = x.shape
        H = self.num_heads
        Dh = E // H
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)

        def heads(t):  # (L, B, E) -> (B, H, L, Dh)
            return t.reshape(L, B, H, Dh).permute(1, 2, 0, 3).contiguous()

        q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
        rate = self.dropout if self.training else 0.0
        seed = kernel_seed(self) if rate > 0.0 else None
        out = fused_attention(q, k, v, valid_len=valid_len, dropout_rate=rate,
                              dropout_seed=seed)
        out = out.permute(2, 0, 1, 3).reshape(L, B, E)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer, torch legacy semantics:

    x = norm1(x + dropout(attn(x)));  x = norm2(x + dropout(ff(x)))
    with ff = linear2(dropout(relu(linear1(x)))) as one fused MLP.
    """

    dropout_seeds: Optional[StepSeeds] = None  # kernel seeds (nn.core)

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.dropout = dropout
        kw = dict(generator=generator, device=device)
        self.self_attn = MultiheadSelfAttention(d_model, nhead, dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)

    def forward(self, x: torch.Tensor, valid_len=None) -> torch.Tensor:
        attn = self.self_attn(x, valid_len=valid_len)
        x = self.norm1(x + F.dropout(attn, self.dropout, self.training))
        rate = self.dropout if self.training else 0.0
        h = fused_mlp(
            x,
            *kernel_layout(self.linear1), *kernel_layout(self.linear2),
            mid=("relu", "act_first", rate),
            dropout_seed=kernel_seed(self) if rate > 0.0 else None,
        )
        return self.norm2(x + F.dropout(h, self.dropout, self.training))


class TransformerEncoder(nn.Module):
    """``num_layers`` post-norm encoder layers, ``layers.0 .. layers.{n-1}``."""

    def __init__(self, d_model: int, nhead: int, num_layers: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.1, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, generator=generator, device=device
            )
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, valid_len=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, valid_len=valid_len)
        return x
