"""The MELD entry point's model (counterpart of
``gan_ffn_tpu/models/baselines.py::MELDLSTMModel``; reference
model.py:520-562, train_MELD.py:147-150).

A 4-layer bidirectional LSTM over the text features, then the reference's
per-timestep ``MatchingAttention`` ("general2", over ``umask``) as one
call over all L queries, the hardswish residual ``hardswish(emotions +
hardswish(att))``, the ``smax_fc`` head and a float32 log-softmax.  With
``att2=False`` the attention is replaced by ``gelu(linear(emotions))``.

With a ``dtype`` the input is cast to it and the LSTM follows it (its
float32 parameters cast at each use); the attention's epilogue is promoted
to float32 by the float32 ``umask``, as in the JAX module, and the
log-softmax is float32.  The other baselines of the JAX module are
library-only (ROADMAP module note 16).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.attention import MatchingAttention
from ..nn.core import Linear, gelu, hardswish
from ..nn.recurrent import LSTM


class MELDLSTMModel(nn.Module):
    """``(U (L, B, D_m), qmask (L, B, P), umask (B, L))`` -> ``(log_prob (L,
    B, n_classes) float32, alpha (L, B, L))``; ``alpha`` is the attention
    weights of each query over the L keys, None with ``att2=False``.
    ``qmask`` is not read, as in the reference; ``valid_len`` is accepted
    for the classifier steps' sake and ignored (the model has no key mask
    but ``umask``)."""

    INPUTS = ("text", "qmask", "umask")
    ATTENTIONS = ("alpha",)
    CONFIG = ("D_m", "D_e", "D_h", "n_classes", "att2")  # serving's meta["config"]
    DROPOUTS = ("dropout",)

    def __init__(self, D_m: int, D_e: int, D_h: int, n_classes: int = 7, dropout: float = 0.5,
                 att2: bool = True, *, generator: Optional[torch.Generator] = None,
                 device="cuda", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.D_m, self.D_e, self.D_h, self.n_classes = D_m, D_e, D_h, n_classes
        self.dropout, self.att2, self.dtype = dropout, att2, dtype
        kw = dict(generator=generator, device=device)
        self.lstm = LSTM(D_m, D_e, num_layers=4, bidirectional=True, dropout=dropout, **kw)
        if att2:
            self.matchatt = MatchingAttention(2 * D_e, 2 * D_e, att_type="general2", **kw)
        else:
            self.linear = Linear(2 * D_e, D_h, **kw)
        self.smax_fc = Linear(2 * D_e if att2 else D_h, n_classes, **kw)

    def forward(self, U: torch.Tensor, qmask: torch.Tensor, umask: torch.Tensor,
                valid_len=None):
        if self.dtype is not None:
            U = U.to(self.dtype)
        emotions, _ = self.lstm(U)
        alpha = None
        if self.att2:
            att_emotions, alpha = self.matchatt(emotions, emotions, umask)
            hidden = hardswish(emotions + hardswish(att_emotions))
            alpha = alpha[:, :, 0, :]
        else:
            hidden = gelu(self.linear(emotions))
        log_prob = torch.log_softmax(self.smax_fc(hidden).float(), dim=2)
        return log_prob, alpha
