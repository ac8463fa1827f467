"""The fused-feature generators (counterpart of
``gan_ffn_tpu/models/generators.py``).

Each generator is PE -> 8-layer post-norm Transformer encoder -> the head
``gelu(dropout(fc2(gelu(dropout(fc1(dropout(gelu(x))))))))``, which runs as
one fused MLP (``ops.mlp.fused_mlp``):

- ``AcousticGenerator``: (L, B, 100) -> (L, B, D_h), 10 heads, head 512
- ``VisualGenerator``:   (L, B, 512) -> (L, B, D_h), 8 heads, head 1024
- ``TextGenerator``:     (L, B, 100) -> (L, B, D_h), 10 heads, head 512

Each wraps a ``_TransformerGenerator`` under ``net``, as the JAX modules do,
so the ``state_dict`` keys follow the JAX parameter tree.  The positional
encoding keeps its module default rate of 0.2 whatever the generator's
``dropout``, as the JAX generator builds it without a rate
(``gan_ffn_tpu/models/generators.py``); ``dropout`` sets the head's three
in-kernel dropouts.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.core import Linear, kernel_layout
from ..nn.positional import PositionalEncoding
from ..nn.transformer import TransformerEncoder
from ..ops.dropout import draw_seed
from ..ops.mlp import fused_mlp

# Bucket lengths may exceed the reference's 110-utterance PE table; padded
# positions beyond the true length are key-masked.
PE_MAX_LEN = 128


class _TransformerGenerator(nn.Module):
    """Shared generator skeleton: PE -> encoder -> fused gelu MLP head."""

    dropout_generator: Optional[torch.Generator] = None  # kernel seeds (nn.core)

    def __init__(self, d_model: int, nhead: int, d_hidden: int, d_out: int,
                 num_layers: int = 8, dropout: float = 0.2, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.dropout = dropout
        kw = dict(generator=generator, device=device)
        self.position_encoding = PositionalEncoding(d_model, max_len=PE_MAX_LEN, device=device)
        self.transformer_encoder = TransformerEncoder(d_model, nhead, num_layers=num_layers, **kw)
        self.fc1 = Linear(d_model, d_hidden, **kw)
        self.fc2 = Linear(d_hidden, d_out, **kw)

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None) -> torch.Tensor:
        x = self.position_encoding(x)
        x = self.transformer_encoder(x, valid_len=valid_len)
        rate = self.dropout if self.training else 0.0
        return fused_mlp(
            x, *kernel_layout(self.fc1), *kernel_layout(self.fc2),
            pre=("gelu", rate),
            mid=("gelu", "drop_first", rate),
            post=("gelu", "drop_first", rate),
            dropout_seed=draw_seed(self.dropout_generator) if rate > 0.0 else None,
        )


class _Generator(nn.Module):
    D_MODEL = NHEAD = D_HIDDEN = 0  # set by each modality

    def __init__(self, D_h: int, dropout: float = 0.2, num_layers: int = 8, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.net = _TransformerGenerator(
            self.D_MODEL, self.NHEAD, self.D_HIDDEN, D_h, num_layers, dropout,
            generator=generator, device=device,
        )

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None) -> torch.Tensor:
        return self.net(x, valid_len=valid_len)


class AcousticGenerator(_Generator):
    """(L, B, 100) -> (L, B, D_h)."""

    D_MODEL, NHEAD, D_HIDDEN = 100, 10, 512


class VisualGenerator(_Generator):
    """(L, B, 512) -> (L, B, D_h)."""

    D_MODEL, NHEAD, D_HIDDEN = 512, 8, 1024


class TextGenerator(_Generator):
    """(L, B, 100) -> (L, B, D_h)."""

    D_MODEL, NHEAD, D_HIDDEN = 100, 10, 512
