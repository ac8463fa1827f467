"""The recurrent cells and the stacked LSTM (counterpart of
``gan_ffn_tpu/nn/recurrent.py``): the GRU cell of the DialogueRNN stack
(reference model.py:848-852) and the LSTM of ``MELDLSTMModel`` (reference
model.py:520-562).

- ``GRUCell``: torch's gate order (r, z, n) and update h' = (1 - z) * n + z
  * h, with ``torch.nn.GRUCell``'s parameter names and layouts
  (``weight_ih (3H, D_in)``, ``weight_hh (3H, H)``, ``bias_ih``,
  ``bias_hh``), so ``tests/torch_mapping.py::gru_cell_params`` maps them to
  the JAX tree.
- ``GRU``: the single-layer ``torch.nn.GRU`` over a sequence, with its
  ``_l0`` parameter names (``BiE2EModel``'s turn encoder), the input
  projection of every step hoisted out of the loop over time.
- ``LSTMCell``, ``LSTM``: torch's gate order (i, f, g, o), c' = f * c + i *
  g, h' = o * tanh(c'), with ``torch.nn.LSTM``'s parameter names
  (``weight_ih_l{k}[_reverse] (4H, in)``, ``weight_hh_l{k}[_reverse]``,
  ``bias_ih_…``, ``bias_hh_…``), so ``tests/torch_mapping.py::lstm_params``
  maps them.  ``LSTM`` is multi-layer and optionally bidirectional, with
  zero initial states and dropout on every layer's output but the last.
  The input projection of every step is one product over all L * B rows;
  the loop over time carries the recurrent half.  The reverse direction
  reads the *whole padded* sequence backwards (the JAX package's
  ``jnp.flip`` over time), not each dialogue: padding flows through, as in
  the reference's unpacked ``nn.LSTM``.  Both directions of a layer run in
  one loop over time, each product batched over a leading direction axis.

Every parameter is drawn from U(-1/sqrt(H), 1/sqrt(H)), torch's default,
from the module's ``generator``.

:func:`gru_step` and :func:`lstm_step` are the steps themselves over
weights with a leading axis, so that the DialogueRNN scan and the LSTM run
both directions' cells as one batch of products; ``GRUCell.forward`` and
``LSTMCell.forward`` are the same steps with that axis of size 1.  The
products are cuBLAS's, as the JAX package leaves them to XLA: no Pallas
kernel computes a GRU or an LSTM.  A step computes at its input's dtype,
its float32 parameters cast at each use (bf16 under ``--bf16``), as the JAX
cells do: each product rounded to the dtype, then the bias added at it
(the LSTM's gates as ``(x W_ih + b_ih) + h W_hh`` and then ``+ b_hh``), and
the LSTM's ``c`` carried at the dtype.  ``torch.nn.LSTM`` (cuDNN) rounds
elsewhere, so it is not used.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .core import uniform_parameter


def stacked_linear(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (X, ..., in) -> (X, ..., out)``: ``x[i] W[i]^T + b[i]`` for each
    ``i`` of the leading axis, as one batched product; ``weight (X, out,
    in)``, ``bias (X, out)`` or None.  At ``x``'s dtype: below float32 the
    weights are cast to it and the bias is added after the product, as
    ``nn.core.linear`` adds it."""
    X, d_in = x.shape[0], x.shape[-1]
    rows = x.reshape(X, -1, d_in)
    wt = weight.to(x.dtype).transpose(1, 2)
    if bias is None:
        y = torch.bmm(rows, wt)
    elif x.dtype == torch.float32:
        y = torch.baddbmm(bias.unsqueeze(1), rows, wt)
    else:
        y = torch.bmm(rows, wt) + bias.to(x.dtype).unsqueeze(1)
    return y.reshape(*x.shape[:-1], weight.shape[1])


def gru_step(x: torch.Tensor, h: torch.Tensor, weight_ih: torch.Tensor,
             weight_hh: torch.Tensor, bias_ih: torch.Tensor,
             bias_hh: torch.Tensor) -> torch.Tensor:
    """One GRU step for each ``i`` of the leading axis: ``x (X, ..., D_in)``,
    ``h (X, ..., H)`` -> ``h' (X, ..., H)``, weights ``(X, 3H, D_in)``,
    ``(X, 3H, H)``, biases ``(X, 3H)``.  ``x`` may have size 1 where ``h``
    has more (the party axis of the DialogueRNN cell): its projection is
    then computed once and broadcast, the same value per row."""
    return gru_update(stacked_linear(x, weight_ih, bias_ih), h, weight_hh, bias_hh)


def gru_update(gi: torch.Tensor, h: torch.Tensor, weight_hh: torch.Tensor,
               bias_hh: torch.Tensor) -> torch.Tensor:
    """:func:`gru_step` from the input's projection with its bias, ``gi (X,
    ..., 3H)``: the recurrent half of the step."""
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


class GRU(nn.Module):
    """Single-layer GRU over ``x (L, B, D_in)`` with ``torch.nn.GRU``'s
    semantics and parameter names (``weight_ih_l0 (3H, D_in)``,
    ``weight_hh_l0 (3H, H)``, ``bias_ih_l0``, ``bias_hh_l0``): ``(outputs
    (L, B, H), h_n (1, B, H))`` from ``h0 (1, B, H)`` or zeros.  The input
    projection of every step is one product over all L * B rows; the loop
    over time runs :func:`gru_update`."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        bound = 1.0 / math.sqrt(hidden_size)
        H3 = 3 * hidden_size
        self.weight_ih_l0 = uniform_parameter((H3, input_size), bound, generator, device)
        self.weight_hh_l0 = uniform_parameter((H3, hidden_size), bound, generator, device)
        self.bias_ih_l0 = uniform_parameter((H3,), bound, generator, device)
        self.bias_hh_l0 = uniform_parameter((H3,), bound, generator, device)

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
        L, B, _ = x.shape
        gi = stacked_linear(x[None], self.weight_ih_l0[None], self.bias_ih_l0[None])
        weight_hh, bias_hh = self.weight_hh_l0[None], self.bias_hh_l0[None]
        h = (x.new_zeros(1, B, self.hidden_size) if h0 is None
             else h0.reshape(1, B, self.hidden_size).to(x.dtype))
        outs = []
        for t in range(L):
            h = gru_update(gi[:, t], h, weight_hh, bias_hh)
            outs.append(h)
        return torch.stack(outs, dim=1)[0], h


def lstm_step(gi: torch.Tensor, h: torch.Tensor, c: torch.Tensor, weight_hh: torch.Tensor,
              bias_hh: torch.Tensor):
    """One LSTM step for each ``i`` of the leading axis: the input's
    projection with its bias ``gi (X, ..., 4H)``, ``h``, ``c (X, ..., H)``,
    ``weight_hh (X, 4H, H)``, ``bias_hh (X, 4H)`` -> ``(h', c')``."""
    gates = (gi + stacked_linear(h, weight_hh)) + bias_hh.to(gi.dtype).unsqueeze(1)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class LSTMCell(nn.Module):
    """One LSTM step: ``x (B, D_in)``, ``(h, c)`` each ``(B, H)`` -> ``(h', c')``."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        bound = 1.0 / math.sqrt(hidden_size)
        H4 = 4 * hidden_size
        self.weight_ih = uniform_parameter((H4, input_size), bound, generator, device)
        self.weight_hh = uniform_parameter((H4, hidden_size), bound, generator, device)
        self.bias_ih = uniform_parameter((H4,), bound, generator, device)
        self.bias_hh = uniform_parameter((H4,), bound, generator, device)

    def forward(self, x: torch.Tensor, state):
        h, c = state
        gi = stacked_linear(x[None], self.weight_ih[None], self.bias_ih[None])
        h, c = lstm_step(gi, h.to(x.dtype)[None], c[None], self.weight_hh[None],
                         self.bias_hh[None])
        return h[0], c[0]


class LSTM(nn.Module):
    """``x (L, B, D)`` -> ``(outputs (L, B, dirs * H), (h_n, c_n))``, ``h_n``
    and ``c_n`` ``(num_layers * dirs, B, H)`` in torch's layer order: the
    semantics of ``torch.nn.LSTM(input_size, hidden_size, num_layers,
    dropout=dropout, bidirectional=bidirectional)`` (see the module
    docstring).  The inter-layer dropout is ``F.dropout``, drawing from
    torch's RNG, in training mode."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.input_size, self.hidden_size, self.num_layers = input_size, hidden_size, num_layers
        self.bidirectional, self.dropout = bidirectional, dropout
        self.suffixes = ("", "_reverse") if bidirectional else ("",)
        bound = 1.0 / math.sqrt(hidden_size)
        H4 = 4 * hidden_size
        for layer in range(num_layers):
            d_in = input_size if layer == 0 else hidden_size * len(self.suffixes)
            for sfx in self.suffixes:
                for name, shape in (("weight_ih", (H4, d_in)), ("weight_hh", (H4, hidden_size)),
                                    ("bias_ih", (H4,)), ("bias_hh", (H4,))):
                    setattr(self, f"{name}_l{layer}{sfx}",
                            uniform_parameter(shape, bound, generator, device))

    def _stacked(self, name: str, layer: int) -> torch.Tensor:
        """The directions' ``name`` parameters of ``layer``, stacked on a new first axis."""
        return torch.stack([getattr(self, f"{name}_l{layer}{sfx}") for sfx in self.suffixes])

    def forward(self, x: torch.Tensor):
        L, B, _ = x.shape
        dirs, H = len(self.suffixes), self.hidden_size
        h_n, c_n = [], []
        layer_in = x
        for layer in range(self.num_layers):
            inputs = torch.stack([layer_in, layer_in.flip(0)][:dirs])  # (dirs, L, B, d_in)
            gi = stacked_linear(inputs, self._stacked("weight_ih", layer),
                                self._stacked("bias_ih", layer))
            weight_hh, bias_hh = self._stacked("weight_hh", layer), self._stacked("bias_hh", layer)
            h = c = x.new_zeros(dirs, B, H)
            outs = []
            for t in range(L):
                h, c = lstm_step(gi[:, t], h, c, weight_hh, bias_hh)
                outs.append(h)
            out = torch.stack(outs, dim=1)  # (dirs, L, B, H)
            layer_in = torch.cat([out[0], out[1].flip(0)], dim=-1) if dirs == 2 else out[0]
            if layer < self.num_layers - 1 and self.dropout > 0.0:
                layer_in = F.dropout(layer_in, self.dropout, self.training)
            h_n.append(h)
            c_n.append(c)
        return layer_in, (torch.cat(h_n), torch.cat(c_n))
