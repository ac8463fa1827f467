"""The fusion classifiers (counterpart of ``gan_ffn_tpu/models/gan_ffn.py``;
reference model.py:1405-1528).  Both sum the three generators' outputs into
the fusion:

- ``GAN_FFN`` classifies each utterance by one linear head and a float32
  log-softmax; its ``dtype`` (None: float32) is the generators' compute
  dtype, and the head runs at the fusion's, as in the JAX module;
- ``GAN_FFN_DialogueRNN`` runs the bidirectional DialogueRNN ``BiModel`` on
  the fusion; with a ``dtype`` the generators compute at it and the
  recurrent stack follows the fusion's dtype (GRU cells, the party blend,
  the states and the attentions; their softmaxes and the log-softmax in
  float32), as in the JAX module.

``INPUTS`` names the batch entries each model takes, in order, before
``valid_len`` (``train/classifier.py`` reads them); ``ATTENTIONS`` names the
attention weights that follow the log-probabilities in its output.
``CONFIG`` names the constructor arguments that a serving artifact records
to rebuild the model, ``DROPOUTS`` the dropout rates that
``serving.bf16_variant`` carries over (``serving.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.core import Linear
from .dialogue_rnn import BiModel
from .generators import AcousticGenerator, TextGenerator, VisualGenerator
from .moonlight import MoonlightConfig, MoonlightGenerator


class GAN_FFN(nn.Module):
    """(acoustic (L,B,100), visual (L,B,512), text (L,B,100)) ->
    log_prob (L,B,n_classes) float32.

    The JAX module also returns three empty attention lists; this one
    returns the log-probabilities alone.  ``text_generator="moonlight"``
    builds the Moonlight stack (``models/moonlight.py``, ``moonlight``'s
    size) as the text generator, which stage A's of the same kind grafts
    into; it routes the utterances below ``valid_len``.
    """

    INPUTS = ("audio", "visual", "text")
    ATTENTIONS = ()
    CONFIG = ("n_classes", "D_h", "gen_num_layers")
    DROPOUTS = ("dropout", "gen_dropout")

    def __init__(self, n_classes: int = 6, dropout: float = 0.2, D_h: int = 100,
                 gen_dropout: float = 0.2, gen_num_layers: int = 8, *,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None, text_generator: str = "transformer",
                 moonlight: Optional[MoonlightConfig] = None):
        super().__init__()
        self.n_classes, self.D_h, self.gen_num_layers = n_classes, D_h, gen_num_layers
        self.dropout = dropout  # unused in the forward, as in the reference
        self.gen_dropout, self.dtype = gen_dropout, dtype
        kw = dict(generator=generator, device=device)
        gen = dict(kw, dtype=dtype)
        self.acoustic_generator = AcousticGenerator(D_h, gen_dropout, gen_num_layers, **gen)
        self.visual_generator = VisualGenerator(D_h, gen_dropout, gen_num_layers, **gen)
        if text_generator == "moonlight":
            if dtype is not None:
                raise ValueError("the Moonlight text generator computes in float32 only")
            self.text_generator = MoonlightGenerator(D_h, gen_dropout,
                                                     moonlight or MoonlightConfig(), **kw)
        else:
            self.text_generator = TextGenerator(D_h, gen_dropout, gen_num_layers, **gen)
        self.fc = Linear(D_h, n_classes, **kw)

    def forward(self, acoustic: torch.Tensor, visual: torch.Tensor, text: torch.Tensor,
                valid_len=None) -> torch.Tensor:
        fusion = (
            self.acoustic_generator(acoustic, valid_len=valid_len)
            + self.visual_generator(visual, valid_len=valid_len)
            + self.text_generator(text, valid_len=valid_len)
        )
        return torch.log_softmax(self.fc(fusion).float(), dim=2)


class GAN_FFN_DialogueRNN(nn.Module):
    """``(acoustic, visual, text, qmask (L,B,P), umask (B,L))`` ->
    ``(log_prob (L,B,n_classes) float32, alpha, alpha_f, alpha_b)``, each
    alpha ``(L, B, L)`` (``models/dialogue_rnn.BiModel``).  The reference's
    unused ``fc1`` (model.py:1512) is left out, as in the JAX package."""

    INPUTS = ("audio", "visual", "text", "qmask", "umask")
    ATTENTIONS = ("alpha", "alpha_f", "alpha_b")
    CONFIG = ("D_m", "D_g", "D_p", "D_e", "D_h", "D_a", "n_classes", "listener_state",
              "context_attention", "gen_num_layers")
    DROPOUTS = ("dropout_rec", "dropout", "gen_dropout")

    def __init__(self, D_m: int = 100, D_g: int = 500, D_p: int = 500, D_e: int = 100,
                 D_h: int = 100, D_a: int = 100, n_classes: int = 6,
                 listener_state: bool = False, context_attention: str = "general",
                 dropout_rec: float = 0.1, dropout: float = 0.6, gen_dropout: float = 0.2,
                 gen_num_layers: int = 8, *, generator: Optional[torch.Generator] = None,
                 device="cuda", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.D_m, self.D_g, self.D_p, self.D_e, self.D_h, self.D_a = D_m, D_g, D_p, D_e, D_h, D_a
        self.n_classes, self.gen_num_layers, self.dtype = n_classes, gen_num_layers, dtype
        self.listener_state, self.context_attention = listener_state, context_attention
        self.dropout_rec, self.dropout, self.gen_dropout = dropout_rec, dropout, gen_dropout
        kw = dict(generator=generator, device=device)
        gen = dict(kw, dtype=dtype)
        self.acoustic_generator = AcousticGenerator(D_h, gen_dropout, gen_num_layers, **gen)
        self.visual_generator = VisualGenerator(D_h, gen_dropout, gen_num_layers, **gen)
        self.text_generator = TextGenerator(D_h, gen_dropout, gen_num_layers, **gen)
        self.bi_model = BiModel(D_m, D_g, D_p, D_e, D_h, n_classes, listener_state,
                                context_attention, D_a, dropout_rec, dropout, **kw)

    def forward(self, acoustic: torch.Tensor, visual: torch.Tensor, text: torch.Tensor,
                qmask: torch.Tensor, umask: torch.Tensor, valid_len=None):
        fusion = (
            self.acoustic_generator(acoustic, valid_len=valid_len)
            + self.visual_generator(visual, valid_len=valid_len)
            + self.text_generator(text, valid_len=valid_len)
        )
        return self.bi_model(fusion, qmask, umask)
