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
log-softmax is float32.

The other baselines of the JAX module are library-only (no entry point
runs them); each returns the JAX module's tuple, its empty ``alpha``
slots as ``[]``, and computes in float32.  Their layers carry the JAX
module's names, so ``utils/weights.state_dict_from_jax`` maps a JAX tree
onto them by layout alone (flax's ``Conv`` kernel ``(fs, E, 1, F)`` to
``Conv2d``'s ``(F, 1, fs, E)``, its 1-D ``(K, E, F)`` to ``Conv1d``'s ``(F,
E, K)``, ``Embed``'s ``embedding`` to ``weight``):

- ``LSTMModel2`` (model.py:474-517): a 2-layer BiLSTM, optionally
  ``MatchingAttention`` (general2) over ``umask``, ``relu(linear)``,
  dropout, ``smax_fc``.
- ``LSTMModel`` (model.py:393-471): three 2-layer BiLSTMs (the visual
  features cut to their first 100), the reference's ``Attention(600)``
  applied to the time-major ``(L, B, 600)`` as if axis 0 were the batch,
  ``gelu(emotion + att)``, dropout, ``smax_fc``; it returns the hidden
  state as a fifth element.
- ``CNN`` (model.py:301-354): full-width ``Conv2d`` windows over time,
  relu, max over time, dropout, ``fc`` and a log-softmax over the classes
  (the reference's own last line indexes a missing axis and crashes).
- ``TextCNN``: the runnable repair of the reference's dead TextCNN
  (model.py:357-390): three single-channel full-width convs (k = 3, 4, 5),
  relu, the max over the first ``sentence_max_size - k + 1`` positions,
  ``linear1`` over the three, raw logits.
- ``FullyConnection`` (model.py:565-586): 100 -> 128 -> 256 -> 512 -> 1024
  -> 2048, exact-erf gelu between.
- ``Emoformer`` (model.py:589-688): two rounds of per-modality
  ``Attention`` with residual LayerNorms (``norm_1`` shared by text, audio
  and the second visual round; ``attention_3`` at ``D_m + 412``, the
  visual width), ``FullyConnection`` towers, then either (``attention=
  False``) ``transform4(text) + towers`` through a 2-layer BiLSTM, or
  (``attention=True``) the 3 x 3 ``matching`` loop through one shared
  ``MatchingAttention(2048)`` and ``transform2(output + text)`` through
  ``lstm_1``.  The ``attention=True`` path adds a 2048-wide output to the
  ``D_m``-wide text, so it raises at any runnable width, as in the
  reference and the JAX package.
- ``CNNFeatureExtractor`` (model.py:691-751): token embeddings, ``Conv1d``
  windows on the channels-first transpose, relu, max over time, dropout,
  ``relu(fc)``, masked by ``umask``.
- ``E2ELSTMModel`` (model.py:754-825): ``CNNFeatureExtractor`` into the
  ``LSTMModel2`` head.

Every dropout is ``F.dropout`` from torch's RNG in training mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import Attention, MatchingAttention, matching
from ..nn.core import Embedding, LayerNorm, Linear, conv, gelu, hardswish
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


def _log_softmax(logits: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=dim)


class LSTMModel2(nn.Module):
    """``(U (L, B, D_m), qmask, umask (B, L))`` -> ``(log_prob (L, B,
    n_classes), alpha (L, B, L) or [], [], [])``."""

    def __init__(self, D_m: int, D_e: int, D_h: int, n_classes: int = 7, dropout: float = 0.5,
                 attention: bool = False, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.dropout, self.attention = dropout, attention
        kw = dict(generator=generator, device=device)
        self.lstm = LSTM(D_m, D_e, num_layers=2, bidirectional=True, dropout=dropout, **kw)
        if attention:
            self.matchatt = MatchingAttention(2 * D_e, 2 * D_e, att_type="general2", **kw)
        self.linear = Linear(2 * D_e, D_h, **kw)
        self.smax_fc = Linear(D_h, n_classes, **kw)

    def forward(self, U: torch.Tensor, qmask, umask: torch.Tensor):
        emotions, _ = self.lstm(U)
        alpha = []
        if self.attention:
            emotions, alpha_t = self.matchatt(emotions, emotions, umask)
            alpha = alpha_t[:, :, 0, :]
        hidden = F.dropout(F.relu(self.linear(emotions)), self.dropout, self.training)
        return _log_softmax(self.smax_fc(hidden), 2), alpha, [], []


class LSTMModel(nn.Module):
    """``(textf, acouf (L, B, D_m), visuf (L, B, >= 100), qmask, umask)``
    -> ``(log_prob (L, B, n_classes), [], [], [], hidden (L, B, 6 D_e))``.
    ``Attention(600)`` needs ``6 D_e = 600``; ``D_h`` is unused, as in the
    reference."""

    def __init__(self, D_m: int, D_e: int, D_h: int, n_classes: int = 7, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.dropout = dropout
        kw = dict(generator=generator, device=device)
        for name, d_in in (("lstm_1", D_m), ("lstm_2", D_m), ("lstm_3", 100)):
            setattr(self, name, LSTM(d_in, D_e, num_layers=2, bidirectional=True,
                                     dropout=dropout, **kw))
        self.attention = Attention(600, **kw)
        self.smax_fc = Linear(6 * D_e, n_classes, **kw)

    def forward(self, textf, acouf, visuf, qmask, umask):
        e1, _ = self.lstm_1(textf)
        e2, _ = self.lstm_2(acouf)
        e3, _ = self.lstm_3(visuf[:, :, :100])
        emotion = torch.cat([e1, e2, e3], dim=-1)
        att, _ = self.attention(emotion, emotion)  # axis 0 (time) taken for the batch
        hidden = F.dropout(gelu(emotion + att), self.dropout, self.training)
        return _log_softmax(self.smax_fc(hidden), 2), [], [], [], hidden


class CNN(nn.Module):
    """``(text (L, B, embedding_dim), qmask, umask)`` -> ``(log_prob (B,
    output_dim), [], [], [], cat (B, num_filter * len(filter_sizes)))``."""

    def __init__(self, embedding_dim: int, num_filter: int, filter_sizes: Sequence[int],
                 output_dim: int, dropout: float = 0.2, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.filter_sizes, self.dropout = tuple(filter_sizes), dropout
        kw = dict(generator=generator, device=device)
        for fs in self.filter_sizes:
            setattr(self, f"conv_{fs}", conv(nn.Conv2d, 1, num_filter, (fs, embedding_dim), **kw))
        self.fc = Linear(num_filter * len(self.filter_sizes), output_dim, **kw)

    def forward(self, text: torch.Tensor, qmask, umask):
        x = text.transpose(0, 1).unsqueeze(1)  # (B, 1, L, E)
        pooled = [F.relu(getattr(self, f"conv_{fs}")(x))[:, :, :, 0].amax(dim=2)
                  for fs in self.filter_sizes]  # each (B, F)
        cat = F.dropout(torch.cat(pooled, dim=1), self.dropout, self.training)
        return _log_softmax(self.fc(cat), -1), [], [], [], cat


class TextCNN(nn.Module):
    """``x (L, B, embedding_dim)`` -> raw logits ``(B, label_num)``.
    ``L`` must be at least ``sentence_max_size``'s windows; positions past
    ``sentence_max_size - k + 1`` are not pooled."""

    def __init__(self, sentence_max_size: int, label_num: int, embedding_dim: int = 100, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.sentence_max_size = sentence_max_size
        kw = dict(generator=generator, device=device)
        for k in (3, 4, 5):
            setattr(self, f"conv{k}", conv(nn.Conv2d, 1, 1, (k, embedding_dim), **kw))
        self.linear1 = Linear(3, label_num, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xb = x.transpose(0, 1).unsqueeze(1)  # (B, 1, L, E)
        feats = []
        for k in (3, 4, 5):
            c = F.relu(getattr(self, f"conv{k}")(xb))  # (B, 1, L - k + 1, 1)
            feats.append(c[:, 0, : self.sentence_max_size - k + 1, 0].amax(dim=1))
        return self.linear1(torch.stack(feats, dim=1))


class FullyConnection(nn.Module):
    """``x (..., in_features)`` -> ``(..., 2048)``."""

    WIDTHS = (128, 256, 512, 1024, 2048)

    def __init__(self, in_features: int = 100, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        widths = (in_features,) + self.WIDTHS
        for i in range(len(self.WIDTHS)):
            setattr(self, f"fc{i + 1}", Linear(widths[i], widths[i + 1], generator=generator,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, len(self.WIDTHS)):
            x = gelu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{len(self.WIDTHS)}")(x)


class Emoformer(nn.Module):
    """``(textf, acouf (L, B, D_m), visuf (L, B, D_m + 412), qmask, umask
    (B, L))`` -> ``(log_prob (L, B, n_classes), alpha, [], [], output (L,
    B, 2 D_e))``; ``alpha`` is ``[]``, or with ``attention`` the last
    matching's ``(L, B, 1, L)``.  The second round attends the 100-wide
    ``transform3`` output with ``Attention(D_m)``, so ``D_m`` is 100, as
    in the reference."""

    def __init__(self, D_m: int, D_e: int, n_classes: int = 7, dropout: float = 0.5,
                 attention: bool = False, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.dropout, self.attention = dropout, attention
        kw = dict(generator=generator, device=device)
        D_v = D_m + 412
        self.norm_1 = LayerNorm(D_m, device=device)
        self.norm_2 = LayerNorm(D_v, device=device)
        for i, width in enumerate((D_m, D_m, D_v, D_m, D_m, D_m), start=1):
            setattr(self, f"attention_{i}", Attention(width, **kw))
        self.transform3 = Linear(D_v, 100, **kw)
        self.transform = Linear(D_v, D_m, **kw)
        self.fc1 = FullyConnection(D_m, **kw)
        self.fc2 = FullyConnection(D_m, **kw)
        self.fc3 = FullyConnection(D_m, **kw)
        lstm = dict(num_layers=2, bidirectional=True, dropout=dropout, **kw)
        if attention:
            self.matchatt = MatchingAttention(2048, 2048, att_type="general2", **kw)
            self.transform2 = Linear(2048, 2 * D_e, **kw)
            self.lstm_1 = LSTM(2 * D_e, D_e, **lstm)
        else:
            self.transform4 = Linear(D_m, 2048, **kw)
            self.lstm = LSTM(2048, D_e, **lstm)
        self.smax_fc = Linear(2 * D_e, n_classes, **kw)

    def forward(self, textf, acouf, visuf, qmask, umask):
        out_t1, _ = self.attention_1(textf, textf)
        out_a1, _ = self.attention_2(acouf, acouf)
        out_v1, _ = self.attention_3(visuf, visuf)
        textf_1 = self.norm_1(textf + out_t1)
        acouf_1 = self.norm_1(acouf + out_a1)
        visuf_1 = F.relu(self.transform3(self.norm_2(visuf + out_v1)))

        out_t2, _ = self.attention_4(textf_1, textf_1)
        out_a2, _ = self.attention_5(acouf_1, acouf_1)
        out_v2, _ = self.attention_6(visuf_1, visuf_1)
        textf_1 = self.norm_1(textf_1 + out_t2)
        acouf_1 = self.norm_1(acouf_1 + out_a2)
        visuf_1 = self.norm_1(visuf_1 + out_v2)

        output, alpha = self.fuse(textf, self.fc1(textf + textf_1), self.fc2(acouf + acouf_1),
                                  self.fc3(self.transform(visuf) + visuf_1), umask)
        output = F.dropout(output, self.dropout, self.training)
        return _log_softmax(self.smax_fc(output), 2), alpha, [], [], output

    def fuse(self, textf_u, textf, acouf, visuf, umask):
        """The fusion of the three 2048-wide towers and the raw text
        ``textf_u`` into the LSTM's ``(output (L, B, 2 D_e), alpha)``: with
        ``attention`` the 3 x 3 ``matching`` loop (``alpha`` its last
        weights) and ``transform2(output + textf_u)``, which needs a
        2048-wide ``textf_u``; else ``transform4(textf_u)`` plus the towers
        (``alpha`` ``[]``)."""
        if not self.attention:
            output, _ = self.lstm(self.transform4(textf_u) + textf + acouf + visuf)
            return output, []
        emotions = (textf, acouf, visuf)
        output = 0.0
        for i in emotions:
            for j in emotions:
                hid, alpha = matching(self.matchatt, i, j, umask)
                output = output + hid
        output, _ = self.lstm_1(self.transform2(output + textf_u))
        return output, alpha


class CNNFeatureExtractor(nn.Module):
    """``(tokens (L, B, W) int, umask (B, L))`` -> utterance features ``(L,
    B, output_size)``, zero where ``umask`` is."""

    def __init__(self, vocab_size: int, embedding_dim: int = 300, output_size: int = 100,
                 filters: int = 50, kernel_sizes: Sequence[int] = (3, 4, 5),
                 dropout: float = 0.5, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.kernel_sizes, self.dropout, self.output_size = tuple(kernel_sizes), dropout, output_size
        kw = dict(generator=generator, device=device)
        self.embedding = Embedding(vocab_size, embedding_dim, **kw)
        for K in self.kernel_sizes:
            setattr(self, f"conv_{K}", conv(nn.Conv1d, embedding_dim, filters, (K,), **kw))
        self.fc = Linear(filters * len(self.kernel_sizes), output_size, **kw)

    def forward(self, tokens: torch.Tensor, umask: torch.Tensor) -> torch.Tensor:
        L, B, W = tokens.shape
        emb = self.embedding(tokens.reshape(L * B, W)).transpose(1, 2)  # (LB, E, W)
        pooled = [F.relu(getattr(self, f"conv_{K}")(emb)).amax(dim=2) for K in self.kernel_sizes]
        cat = F.dropout(torch.cat(pooled, dim=1), self.dropout, self.training)
        feat = F.relu(self.fc(cat)).reshape(L, B, self.output_size)
        return feat * umask.t().unsqueeze(-1).to(feat.dtype)


class E2ELSTMModel(nn.Module):
    """``(input_seq (L, B, W) int, qmask, umask (B, L))`` -> ``(log_prob
    (L, B, n_classes), alpha (L, B, L) or [], [], [])``."""

    def __init__(self, D_e: int, D_h: int, vocab_size: int, embedding_dim: int = 300,
                 cnn_output_size: int = 100, cnn_filters: int = 50,
                 cnn_kernel_sizes: Sequence[int] = (3, 4, 5), cnn_dropout: float = 0.5,
                 n_classes: int = 7, dropout: float = 0.5, attention: bool = False, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.dropout, self.attention = dropout, attention
        kw = dict(generator=generator, device=device)
        self.cnn_feat_extractor = CNNFeatureExtractor(
            vocab_size, embedding_dim, cnn_output_size, cnn_filters, cnn_kernel_sizes,
            cnn_dropout, **kw)
        self.lstm = LSTM(cnn_output_size, D_e, num_layers=2, bidirectional=True,
                         dropout=dropout, **kw)
        if attention:
            self.matchatt = MatchingAttention(2 * D_e, 2 * D_e, att_type="general2", **kw)
        self.linear = Linear(2 * D_e, D_h, **kw)
        self.smax_fc = Linear(D_h, n_classes, **kw)

    def forward(self, input_seq: torch.Tensor, qmask, umask: torch.Tensor):
        emotions, _ = self.lstm(self.cnn_feat_extractor(input_seq, umask))
        alpha = []
        if self.attention:
            emotions, alpha_t = self.matchatt(emotions, emotions, umask)
            alpha = alpha_t[:, :, 0, :]
        hidden = F.dropout(F.relu(self.linear(emotions)), self.dropout, self.training)
        return _log_softmax(self.smax_fc(hidden), 2), alpha, [], []
