"""The feature discriminators (counterpart of
``gan_ffn_tpu/models/discriminators.py``; reference model.py:1297-1397).

Each discriminator maps a ``(L, B, D_h)`` fusion-space sequence to
per-utterance real/fake probabilities ``(L, B, 1)``: PE -> 8-layer post-norm
encoder (d = D_h, 10 heads; its attention and FFN run the hand-written
kernels) -> the head

    sigmoid(dropout(fc3(gelu(dropout(fc2(gelu(dropout(fc1(gelu(x))))))))))

with ``fc1`` D_h -> 64, ``fc2`` 64 -> 16 and ``fc3`` 16 -> 1.  The head is
plain ``F.linear`` and ``F.dropout`` (torch's RNG), as the JAX package runs
it outside any kernel; its op order is the reference's.

``VisualDiscriminator`` also owns ``object: Linear(512, 100)``, applied iff
the input's last dim is 512: the raw visual features of the "real" path.

Each wraps a ``_TransformerDiscriminator`` under ``net``, as the JAX modules
do, so the ``state_dict`` keys follow the JAX parameter tree.  ``dtype`` is
the compute dtype (None: float32), threaded as the JAX modules thread it:
the input cast on entry, the positional encoding added at it, the encoder,
``fc1``-``fc3`` (and ``object``) and the sigmoid at it, the parameters
float32 and cast at each use.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import Linear, gelu
from ..nn.positional import PositionalEncoding
from ..nn.transformer import TransformerEncoder
from .generators import PE_MAX_LEN

RAW_VISUAL_DIM = 512


class _TransformerDiscriminator(nn.Module):
    """Shared discriminator skeleton: PE -> encoder -> gelu -> FC head."""

    def __init__(self, d_model: int, nhead: int, num_layers: int = 8, dropout: float = 0.2, *,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.position_encoding = PositionalEncoding(d_model, max_len=PE_MAX_LEN, device=device)
        self.transformer_encoder = TransformerEncoder(d_model, nhead, num_layers=num_layers, **kw)
        self.fc1 = Linear(d_model, 64, **kw)
        self.fc2 = Linear(64, 16, **kw)
        self.fc3 = Linear(16, 1, **kw)

    def forward(self, x: torch.Tensor, valid_len=None) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.position_encoding(x)
        x = gelu(self.transformer_encoder(x, valid_len=valid_len))
        x = gelu(F.dropout(self.fc1(x), self.dropout, self.training))
        x = gelu(F.dropout(self.fc2(x), self.dropout, self.training))
        return torch.sigmoid(F.dropout(self.fc3(x), self.dropout, self.training))


class _Discriminator(nn.Module):
    def __init__(self, D_h: int = 100, dropout: float = 0.2, num_layers: int = 8, *,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.net = _TransformerDiscriminator(D_h, 10, num_layers, dropout,
                                             generator=generator, device=device, dtype=dtype)

    def forward(self, fusion: torch.Tensor, valid_len=None) -> torch.Tensor:
        return self.net(fusion, valid_len=valid_len)


class AcousticDiscriminator(_Discriminator):
    """(L, B, D_h) -> (L, B, 1)."""


class VisualDiscriminator(_Discriminator):
    """(L, B, 512 or D_h) -> (L, B, 1); a 512-wide input goes through
    ``object`` first."""

    def __init__(self, D_h: int = 100, dropout: float = 0.2, num_layers: int = 8, *,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        super().__init__(D_h, dropout, num_layers, generator=generator, device=device,
                         dtype=dtype)
        self.object = Linear(RAW_VISUAL_DIM, 100, generator=generator, device=device, dtype=dtype)

    def forward(self, fusion: torch.Tensor, valid_len=None) -> torch.Tensor:
        if fusion.shape[-1] == RAW_VISUAL_DIM:
            fusion = self.object(fusion)
        return self.net(fusion, valid_len=valid_len)


class TextDiscriminator(_Discriminator):
    """(L, B, D_h) -> (L, B, 1)."""
