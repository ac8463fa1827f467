"""DialogueRNN and the bidirectional ``BiModel`` (counterpart of
``gan_ffn_tpu/models/dialogue_rnn.py``; reference model.py:828-1062).

A timestep of ``DialogueRNNCell`` (reference model.py:828-930), per
dialogue of the batch:

- the speaker is ``argmax(qmask_t)``; a padding row has an all-zero qmask,
  so its speaker is party 0, whose state it updates (padding is masked out
  of the loss), as in the reference;
- global state ``g_ = GRU_g([U_t, q_speaker], g_{t-1})``, dropped out before
  it enters the history;
- context ``c_`` = the context attention over the history of ``g`` at
  positions < t, queried by ``U_t``; at t = 0 the history is empty and
  ``c_`` and alpha are exactly 0;
- party states ``qs_ = GRU_p([U_t, c_], q)`` for every party (with
  ``listener_state``, the listeners' through ``GRU_l([U_t, qs_speaker],
  q)``), blended by ``qmask_t``; emotion ``e_ = GRU_e(q_speaker, e)``.

The history is a list of the steps' ``g_``, attended over as
``torch.stack`` of the prefix, as the reference's growing ``torch.cat``:
an in-place write into a preallocated buffer (the JAX package's
``dynamic_update_slice``) would change a tensor that autograd saved.  Each
step's alpha is padded with zeros to length L.

:func:`dialogue_scan` runs one or more directions' cells in one loop over
t, each product batched over a leading direction axis (the JAX package's
``_stacked_bidir_scan``), so BiModel's two scans cost the launches of one.
The direction axis only batches, it never mixes directions: each
direction's math is that of the JAX package's two-scan path, for every
context attention and with or without ``listener_state``.  ``DialogueRNN``
is the same loop with one direction.

Dropout: the cell's three (four with ``listener_state``) sites run at
``dropout_rec`` and BiModel's post-scan dropout on the emotions at
``dropout + 0.15`` (a reference quirk, model.py:1004), both ``F.dropout``
drawing from torch's RNG; the dropout after ``linear`` runs at
``dropout``.

``BiE2EModel`` (reference model.py:1065-1175) is the end-to-end 3-turn
variant: one ``Embedding`` and one single-layer ``GRU`` (``turn_rnn``)
shared by the three token turns, each turn's last hidden state an
utterance, so the dialogue is 3 utterances long with the fixed speakers
``[[1, 0], [0, 1], [1, 0]]`` and no padding; both directions run through
:func:`dialogue_scan` as in BiModel.  Its post-scan dropout runs at
``dropout`` (not BiModel's ``dropout + 0.15``): once on the forward
emotions, then once on both directions' concatenation, as in the JAX
module.  The classifier reads the last utterance, through
``MatchingAttention`` (general2, no mask, queried by the last emotion)
with ``att2``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import MatchingAttention, SimpleAttention, matching_attention, simple_attention
from ..nn.core import Embedding, Linear
from ..nn.recurrent import GRU, GRUCell, gru_step


def _select_parties(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``q (..., P, D)``, ``idx (...)`` int -> ``q[..., idx, :]`` ``(..., D)``."""
    index = idx[..., None, None].expand(*idx.shape, 1, q.shape[-1])
    return q.gather(-2, index).squeeze(-2)


def reverse_padded(x: torch.Tensor, umask: torch.Tensor) -> torch.Tensor:
    """``x (L, B, D)``, ``umask (B, L)``: each dialogue's valid prefix
    flipped in place, zeros at the tail (reference ``_reverse_seq``,
    model.py:1016-1029).  A fully padded column stays zero."""
    L = x.shape[0]
    lengths = umask.sum(dim=1).to(torch.int64)  # (B,)
    t = torch.arange(L, device=x.device)[:, None]  # (L, 1)
    src = (lengths[None, :] - 1 - t).clamp(0, L - 1)  # (L, B)
    gathered = x.gather(0, src[:, :, None].expand_as(x))
    return gathered * (t < lengths[None, :]).to(x.dtype)[:, :, None]


class DialogueRNNCell(nn.Module):
    """One direction's timestep parameters: ``g_cell``, ``p_cell``,
    ``e_cell``, ``l_cell`` (with ``listener_state``) and the context
    ``attention`` (``SimpleAttention`` for ``simple``, else
    ``MatchingAttention`` of that type).  The step itself is
    :func:`dialogue_scan`'s, over one or more such cells."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, listener_state: bool = False,
                 context_attention: str = "simple", D_a: int = 100, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.D_g, self.D_p, self.D_e = D_g, D_p, D_e
        self.listener_state, self.context_attention = listener_state, context_attention
        self.dropout = dropout
        kw = dict(generator=generator, device=device)
        self.g_cell = GRUCell(D_m + D_p, D_g, **kw)
        self.p_cell = GRUCell(D_m + D_g, D_p, **kw)
        self.e_cell = GRUCell(D_p, D_e, **kw)
        if listener_state:
            self.l_cell = GRUCell(D_m + D_p, D_p, **kw)
        if context_attention == "simple":
            self.attention = SimpleAttention(D_g, **kw)
        else:
            self.attention = MatchingAttention(D_g, D_m, D_a, context_attention, **kw)


def _stack(tensors: Sequence[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
    if tensors[0] is None:
        return None
    return tensors[0].unsqueeze(0) if len(tensors) == 1 else torch.stack(list(tensors))


def _gru_params(cells: Sequence[DialogueRNNCell], name: str):
    grus = [getattr(c, name) for c in cells]
    return tuple(_stack([getattr(g, p) for g in grus])
                 for p in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))


def dialogue_scan(cells: Sequence[DialogueRNNCell], U: torch.Tensor, qmask: torch.Tensor,
                  training: bool):
    """The DialogueRNN scan of ``X = len(cells)`` directions at once:
    ``U (X, L, B, D_m)``, ``qmask (X, L, B, P)`` -> ``e (X, L, B, D_e)``,
    ``alpha (X, L, B, L)`` (zero at positions >= t).  The cells share their
    configuration; direction ``i`` runs ``cells[i]``'s parameters on
    ``U[i]``."""
    cell = cells[0]
    X, L, B, _ = U.shape
    P = qmask.shape[-1]
    rate = cell.dropout if training else 0.0
    g_p, p_p, e_p = (_gru_params(cells, n) for n in ("g_cell", "p_cell", "e_cell"))
    l_p = _gru_params(cells, "l_cell") if cell.listener_state else None
    if cell.context_attention == "simple":
        att_w = _stack([c.attention.scalar.weight for c in cells])
    else:
        att_w = tuple(_stack(ws) for ws in zip(*(c.attention.weights() for c in cells)))
    qmask = qmask.to(U.dtype)

    def drop(v):
        return F.dropout(v, rate, training=True) if rate > 0.0 else v

    history: List[torch.Tensor] = []  # g_ of each step, (X, B, D_g)
    q = U.new_zeros(X, B, P, cell.D_p)
    e = U.new_zeros(X, B, cell.D_e)
    es, alphas = [], []
    for t in range(L):
        U_t, qmask_t = U[:, t], qmask[:, t]  # (X, B, D_m), (X, B, P)
        speaker = qmask_t.argmax(dim=-1)  # (X, B)
        g_prev = history[-1] if history else U.new_zeros(X, B, cell.D_g)
        g_ = drop(gru_step(torch.cat([U_t, _select_parties(q, speaker)], -1), g_prev, *g_p))

        if history:
            M = torch.stack(history, dim=2)  # (X, B, t, D_g)
            if cell.context_attention == "simple":
                c_, alpha = simple_attention(M, att_w)
            else:
                c_, alpha = matching_attention(cell.context_attention, M, U_t.unsqueeze(2),
                                               None, *att_w)
                c_, alpha = c_[:, :, 0], alpha[:, :, 0]
            alpha = F.pad(alpha, (0, L - t))
        else:
            c_ = U.new_zeros(X, B, cell.D_g)
            alpha = U.new_zeros(X, B, L)

        # the party GRU's input is the same for every party: projected once
        qs_ = drop(gru_step(torch.cat([U_t, c_], -1).unsqueeze(2), q, *p_p))  # (X, B, P, D_p)
        if l_p is not None:
            listen_in = torch.cat([U_t, _select_parties(qs_, speaker)], -1).unsqueeze(2)
            ql_ = drop(gru_step(listen_in, q, *l_p))
        else:
            ql_ = q
        qm = qmask_t.unsqueeze(-1)
        q = ql_ * (1.0 - qm) + qs_ * qm
        e = drop(gru_step(_select_parties(q, speaker), e, *e_p))
        history.append(g_)
        es.append(e)
        alphas.append(alpha)
    return torch.stack(es, dim=1), torch.stack(alphas, dim=1)


class DialogueRNN(nn.Module):
    """``U (L, B, D_m)``, ``qmask (L, B, P)`` -> ``e (L, B, D_e)``,
    ``alpha (L, B, L)`` (reference model.py:933-978)."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, listener_state: bool = False,
                 context_attention: str = "simple", D_a: int = 100, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.dialogue_cell = DialogueRNNCell(
            D_m, D_g, D_p, D_e, listener_state, context_attention, D_a, dropout,
            generator=generator, device=device)

    def forward(self, U: torch.Tensor, qmask: torch.Tensor):
        e, alpha = dialogue_scan([self.dialogue_cell], U[None], qmask[None], self.training)
        return e[0], alpha[0]


class BiModel(nn.Module):
    """Bidirectional DialogueRNN classifier (reference model.py:981-1062):
    ``U (L, B, D_m)``, ``qmask (L, B, P)``, ``umask (B, L)`` ->
    ``(log_prob (L, B, n_classes) float32, alpha, alpha_f, alpha_b)``, each
    alpha ``(L, B, L)``: att2's over the emotions (None without ``att2``),
    and the two directions' context attentions, ``alpha_b`` in reversed
    time, as the scan gives it."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, D_h: int, n_classes: int = 7,
                 listener_state: bool = False, context_attention: str = "simple",
                 D_a: int = 100, dropout_rec: float = 0.5, dropout: float = 0.5,
                 att2: bool = True, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.dropout, self.att2 = dropout, att2
        kw = dict(generator=generator, device=device)
        rnn = (D_m, D_g, D_p, D_e, listener_state, context_attention, D_a, dropout_rec)
        self.dialog_rnn_f = DialogueRNN(*rnn, **kw)
        self.dialog_rnn_r = DialogueRNN(*rnn, **kw)
        if att2:
            self.matchatt = MatchingAttention(2 * D_e, 2 * D_e, att_type="general2", **kw)
        self.linear = Linear(2 * D_e, 2 * D_h, **kw)
        self.smax_fc = Linear(2 * D_h, n_classes, **kw)

    def forward(self, U: torch.Tensor, qmask: torch.Tensor, umask: torch.Tensor):
        cells = [self.dialog_rnn_f.dialogue_cell, self.dialog_rnn_r.dialogue_cell]
        e, alpha_dir = dialogue_scan(
            cells, torch.stack([U, reverse_padded(U, umask)]),
            torch.stack([qmask, reverse_padded(qmask, umask)]), self.training)
        rate_rec = self.dropout + 0.15
        emotions_f = F.dropout(e[0], rate_rec, self.training)
        emotions_b = F.dropout(reverse_padded(e[1], umask), rate_rec, self.training)
        emotions = torch.cat([emotions_f, emotions_b], dim=-1)  # (L, B, 2 D_e)
        alpha = None
        if self.att2:
            emotions, alpha = self.matchatt(emotions, emotions, umask)
            alpha = alpha[:, :, 0, :]
        hidden = F.dropout(F.relu(self.linear(emotions)), self.dropout, self.training)
        log_prob = torch.log_softmax(self.smax_fc(hidden).float(), dim=2)
        return log_prob, alpha, alpha_dir[0], alpha_dir[1]


class BiE2EModel(nn.Module):
    """``(turn1, turn2, turn3)``, each ``(T, B)`` token ids -> ``log_prob (B,
    n_classes)`` float32 (see the module docstring)."""

    QMASK = ((1.0, 0.0), (0.0, 1.0), (1.0, 0.0))  # the three turns' speakers

    def __init__(self, D_emb: int, D_m: int, D_g: int, D_p: int, D_e: int, D_h: int,
                 vocab_size: int, n_classes: int = 7, listener_state: bool = False,
                 context_attention: str = "simple", D_a: int = 100, dropout_rec: float = 0.5,
                 dropout: float = 0.5, att2: bool = False, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.dropout, self.att2 = dropout, att2
        kw = dict(generator=generator, device=device)
        self.embedding = Embedding(vocab_size, D_emb, **kw)
        self.turn_rnn = GRU(D_emb, D_m, **kw)
        rnn = (D_m, D_g, D_p, D_e, listener_state, context_attention, D_a, dropout_rec)
        self.dialog_rnn_f = DialogueRNN(*rnn, **kw)
        self.dialog_rnn_r = DialogueRNN(*rnn, **kw)
        if att2:
            self.matchatt = MatchingAttention(2 * D_e, 2 * D_e, att_type="general2", **kw)
        self.linear1 = Linear(2 * D_e, D_h, **kw)
        self.smax_fc = Linear(D_h, n_classes, **kw)

    def forward(self, turn1: torch.Tensor, turn2: torch.Tensor, turn3: torch.Tensor):
        U = torch.stack([self.turn_rnn(self.embedding(turn))[1][0]
                         for turn in (turn1, turn2, turn3)])  # (3, B, D_m)
        B = U.shape[1]
        qmask = torch.tensor(self.QMASK, dtype=U.dtype, device=U.device)[:, None].expand(3, B, 2)
        umask = U.new_ones(B, 3)
        cells = [self.dialog_rnn_f.dialogue_cell, self.dialog_rnn_r.dialogue_cell]
        e, _ = dialogue_scan(cells, torch.stack([U, reverse_padded(U, umask)]),
                             torch.stack([qmask, reverse_padded(qmask, umask)]), self.training)
        emotions_f = F.dropout(e[0], self.dropout, self.training)
        emotions = torch.cat([emotions_f, reverse_padded(e[1], umask)], dim=-1)
        emotions = F.dropout(emotions, self.dropout, self.training)
        last = emotions[-1]
        if self.att2:
            last, _ = self.matchatt(emotions, last)
        hidden = F.relu(self.linear1(last))
        return torch.log_softmax(self.smax_fc(hidden).float(), dim=-1)
