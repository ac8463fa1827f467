"""Sinusoidal positional encoding (counterpart of
``gan_ffn_tpu/nn/positional.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, 1, d_model) table: sin on even dims, cos on odd dims,
    including the odd-d_model case where the cos half is one column shorter."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, 1, d_model), dtype=np.float32)
    pe[:, 0, 0::2] = np.sin(position * div_term)
    pe[:, 0, 1::2] = np.cos(position * div_term)[:, : d_model // 2]
    return pe


class PositionalEncoding(nn.Module):
    """x (L, B, D) -> dropout(x + PE[:L]), with torch's dropout RNG."""

    def __init__(self, d_model: int, dropout: float = 0.2, max_len: int = 110, *,
                 device="cuda"):
        super().__init__()
        self.dropout = dropout
        self.max_len = max_len
        table = torch.from_numpy(sinusoidal_table(max_len, d_model)).to(device)
        self.register_buffer("pe", table, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = x.shape[0]
        if L > self.max_len:
            raise ValueError(f"sequence length {L} exceeds max_len {self.max_len}")
        return F.dropout(x + self.pe[:L].to(x.dtype), self.dropout, self.training)
