"""Plain PyTorch reference of ``GAN_FFN_DialogueRNN`` and its train step
(Jing-yilin/GAN-FFN ``model.py``: DialogueRNNCell, DialogueRNN, BiModel,
MatchingAttention; ``train_IEMOCAP_DialogueRNN.py``: MaskedNLLLoss with the
class weights, Adam with L2).

The three generators of ``gan_ffn.py`` (under ``acoustic_generator.`` and so
on) are summed into the fusion ``U``, which runs through the bidirectional
DialogueRNN: the backward direction reads each dialogue's valid prefix
reversed, and both directions run in one loop over time, each product
batched over a leading direction axis (so the dropout draws are those of the
program's stacked scan).  A timestep per direction:

- speaker = argmax(qmask_t) (an all-zero padding row: party 0);
- ``g_ = drop(GRU_g([U_t, q_speaker], g_prev))``;
- context ``c_`` = the ``general`` matching attention of ``U_t`` over the
  history of ``g_`` (zero at t = 0);
- ``qs_ = drop(GRU_p([U_t, c_], q))`` for each party, ``q = q (1 - qm) + qs_ qm``;
- ``e = drop(GRU_e(q_speaker, e))``.

The emotions of both directions (the backward one flipped back) go through
dropout ``dropout + 0.15``, the ``general2`` matching attention over the
dialogue (masked by ``umask``), ``relu(linear)``, dropout and ``smax_fc`` to
log-probabilities.  The loss is the masked NLL weighted by class over the
batch-first flattened utterances.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..lib.philox import StepStream
from .common import Adam, linear, mm, torch_dropout
from .gan_ffn import generator

GENERATORS = (("acoustic_generator", "acoustic", "audio"),
              ("visual_generator", "visual", "visual"),
              ("text_generator", "text", "text"))


def xlin(x, w, b=None):
    """``x (X, ..., in) @ w[i]^T + b[i]`` per direction ``i``; ``w (X, out, in)``."""
    X = x.shape[0]
    y = mm(x.reshape(X, -1, x.shape[-1]), w.transpose(1, 2))
    if b is not None:
        y = y + b[:, None, :]
    return y.reshape(*x.shape[:-1], w.shape[1])


def gru(x, h, w_ih, w_hh, b_ih, b_hh):
    i_r, i_z, i_n = xlin(x, w_ih, b_ih).chunk(3, -1)
    h_r, h_z, h_n = xlin(h, w_hh, b_hh).chunk(3, -1)
    r, z = torch.sigmoid(i_r + h_r), torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def reverse_padded(x, umask):
    L = x.shape[0]
    lengths = umask.sum(1).long()
    t = torch.arange(L, device=x.device)[:, None]
    src = (lengths[None, :] - 1 - t).clamp(0, L - 1)
    out = x.gather(0, src[:, :, None].expand_as(x))
    return out * (t < lengths[None, :]).to(x.dtype)[:, :, None]


def _party(q, idx):
    return q.gather(-2, idx[..., None, None].expand(*idx.shape, 1, q.shape[-1])).squeeze(-2)


def scan(W: Mapping, U, qmask, train: bool, cfg):
    """Both directions' cells over ``U (2, L, B, D_m)``, ``qmask (2, L, B, P)``."""
    c = cfg["dialoguernn"]
    rate = c["dropout_rec"] if train else 0.0
    cells = ("bi_model.dialog_rnn_f.dialogue_cell.", "bi_model.dialog_rnn_r.dialogue_cell.")

    def stacked(name):
        return torch.stack([W[cell + name] for cell in cells])

    g_p, p_p, e_p = ([stacked(f"{cell}.{w}") for w in ("weight_ih", "weight_hh", "bias_ih",
                                                        "bias_hh")]
                     for cell in ("g_cell", "p_cell", "e_cell"))
    att = stacked("attention.transform.weight")
    X, L, B, _ = U.shape
    P = qmask.shape[-1]
    q = U.new_zeros(X, B, P, c["D_p"])
    e = U.new_zeros(X, B, c["D_e"])
    history, es = [], []
    for t in range(L):
        U_t, qm_t = U[:, t], qmask[:, t]
        speaker = qm_t.argmax(-1)
        g_prev = history[-1] if history else U.new_zeros(X, B, c["D_g"])
        g_ = torch_dropout(gru(torch.cat([U_t, _party(q, speaker)], -1), g_prev, *g_p),
                           rate, train)
        if history:
            M = torch.stack(history, 2)  # (X, B, t, D_g)
            query = xlin(U_t.unsqueeze(2), att)  # (X, B, 1, D_g)
            alpha = torch.softmax(mm(query, M.transpose(-1, -2)), -1)
            c_ = mm(alpha, M)[:, :, 0]
        else:
            c_ = U.new_zeros(X, B, c["D_g"])
        qs_ = torch_dropout(gru(torch.cat([U_t, c_], -1).unsqueeze(2), q, *p_p), rate, train)
        qm = qm_t.unsqueeze(-1)
        q = q * (1.0 - qm) + qs_ * qm
        e = torch_dropout(gru(_party(q, speaker), e, *e_p), rate, train)
        history.append(g_)
        es.append(e)
    return torch.stack(es, 1)  # (X, L, B, D_e)


def bimodel(W: Mapping, U, qmask, umask, train: bool, cfg):
    c = cfg["dialoguernn"]
    e = scan(W, torch.stack([U, reverse_padded(U, umask)]),
             torch.stack([qmask, reverse_padded(qmask, umask)]), train, cfg)
    rate = c["dropout"] + 0.15
    em = torch.cat([torch_dropout(e[0], rate, train),
                    torch_dropout(reverse_padded(e[1], umask), rate, train)], -1)  # (L, B, 2 D_e)
    M = em.transpose(0, 1)  # (B, L, 2 D_e)
    m = umask.unsqueeze(1)  # (B, 1, L)
    xt = linear(M, W["bi_model.matchatt.transform.weight"], W["bi_model.matchatt.transform.bias"])
    scores = torch.tanh(mm(xt, (M * umask.unsqueeze(-1)).transpose(-1, -2)) * m)
    alpha = torch.softmax(scores, -1) * m
    denom = alpha.sum(-1, keepdim=True)
    alpha = alpha / torch.where(denom > 0, denom, torch.ones_like(denom))
    pooled = mm(alpha, M).transpose(0, 1)  # (L, B, 2 D_e)
    hidden = torch_dropout(torch.relu(linear(pooled, W["bi_model.linear.weight"],
                                             W["bi_model.linear.bias"])), c["dropout"], train)
    return torch.log_softmax(linear(hidden, W["bi_model.smax_fc.weight"],
                                    W["bi_model.smax_fc.bias"]), dim=2)


def forward(W: Mapping, batch: Mapping, train: bool, cfg, stream: StepStream):
    vl = batch["valid_len"]
    fusion = sum(generator(W, prefix + ".", mod, batch[key], vl, train, cfg, stream)
                 for prefix, mod, key in GENERATORS)
    return bimodel(W, fusion, batch["qmask"], batch["umask"], train, cfg)


def make_params(weights: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}


def make_adam(params: Dict[str, torch.Tensor], cfg) -> Adam:
    o = cfg["optimizer"]
    return Adam(params, o["lr"], (o["b1"], o["b2"]), o["eps"], o["weight_decay"])


def train_step(params: Dict[str, torch.Tensor], adam: Adam, batch: Mapping, cfg,
               fault: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """One train step; returns (loss, predictions over the batch-first
    flattened utterances).  ``fault == "half_batch"``: the loss over the
    first half of the batch's dialogues only."""
    log_prob = forward(params, batch, True, cfg, StepStream(batch["seed"]))
    n_classes = log_prob.shape[-1]
    lp = log_prob.transpose(0, 1).reshape(-1, n_classes)
    umask = batch["umask"]
    if fault == "half_batch":
        umask = umask.clone()
        umask[umask.shape[0] // 2:] = 0.0
    mask, target = umask.reshape(-1), batch["label"].reshape(-1)
    w = torch.tensor(cfg["class_weights"], device=lp.device)[target]
    picked = lp.gather(1, target[:, None])[:, 0] * mask
    loss = -(w * picked).sum() / (w * mask).sum()
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    adam.step(dict(zip(names, grads)))
    return loss.detach(), lp.argmax(1)
