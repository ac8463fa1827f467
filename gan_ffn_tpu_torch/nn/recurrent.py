"""The GRU cell of the DialogueRNN stack (counterpart of
``gan_ffn_tpu/nn/recurrent.py::GRUCell``; reference model.py:848-852).

Torch's gate order (r, z, n) and update h' = (1 - z) * n + z * h, with
``torch.nn.GRUCell``'s parameter names and layouts (``weight_ih (3H, D_in)``,
``weight_hh (3H, H)``, ``bias_ih``, ``bias_hh``), so
``tests/torch_mapping.py::gru_cell_params`` maps them to the JAX tree.  Every
parameter is drawn from U(-1/sqrt(H), 1/sqrt(H)), torch's default, from the
module's ``generator``.

:func:`gru_step` is the step itself over weights with a leading axis, so
that the DialogueRNN scan runs both directions' cells as one batch of
products (``models/dialogue_rnn.py``); ``GRUCell.forward`` is the same step
with that axis of size 1.  The products are cuBLAS's, as the JAX package
leaves them to XLA: no Pallas kernel computes a GRU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .core import uniform_parameter


def stacked_linear(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (X, ..., in) -> (X, ..., out)``: ``x[i] W[i]^T + b[i]`` for each
    ``i`` of the leading axis, as one batched product; ``weight (X, out,
    in)``, ``bias (X, out)`` or None."""
    X, d_in = x.shape[0], x.shape[-1]
    rows = x.reshape(X, -1, d_in)
    wt = weight.transpose(1, 2)
    y = torch.bmm(rows, wt) if bias is None else torch.baddbmm(bias.unsqueeze(1), rows, wt)
    return y.reshape(*x.shape[:-1], weight.shape[1])


def gru_step(x: torch.Tensor, h: torch.Tensor, weight_ih: torch.Tensor,
             weight_hh: torch.Tensor, bias_ih: torch.Tensor,
             bias_hh: torch.Tensor) -> torch.Tensor:
    """One GRU step for each ``i`` of the leading axis: ``x (X, ..., D_in)``,
    ``h (X, ..., H)`` -> ``h' (X, ..., H)``, weights ``(X, 3H, D_in)``,
    ``(X, 3H, H)``, biases ``(X, 3H)``.  ``x`` may have size 1 where ``h``
    has more (the party axis of the DialogueRNN cell): its projection is
    then computed once and broadcast, the same value per row."""
    gi = stacked_linear(x, weight_ih, bias_ih)
    gh = stacked_linear(h, weight_hh, bias_hh)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


class GRUCell(nn.Module):
    """One GRU step: ``x (B, D_in)``, ``h (B, H)`` -> ``h' (B, H)``."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        bound = 1.0 / math.sqrt(hidden_size)
        H3 = 3 * hidden_size
        self.weight_ih = uniform_parameter((H3, input_size), bound, generator, device)
        self.weight_hh = uniform_parameter((H3, hidden_size), bound, generator, device)
        self.bias_ih = uniform_parameter((H3,), bound, generator, device)
        self.bias_hh = uniform_parameter((H3,), bound, generator, device)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        params = (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)
        return gru_step(x[None], h[None], *(p[None] for p in params))[0]
