"""The fusion classifiers (counterpart of ``gan_ffn_tpu/models/gan_ffn.py``;
reference model.py:1405-1528).  Both sum the three generators' outputs into
the fusion:

- ``GAN_FFN`` classifies each utterance by one linear head and a float32
  log-softmax;
- ``GAN_FFN_DialogueRNN`` runs the bidirectional DialogueRNN ``BiModel`` on
  the fusion.

``INPUTS`` names the batch entries each model takes, in order, before
``valid_len`` (``train/classifier.py`` reads them); ``ATTENTIONS`` names the
attention weights that follow the log-probabilities in its output.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.core import Linear
from .dialogue_rnn import BiModel
from .generators import AcousticGenerator, TextGenerator, VisualGenerator


class GAN_FFN(nn.Module):
    """(acoustic (L,B,100), visual (L,B,512), text (L,B,100)) ->
    log_prob (L,B,n_classes) float32.

    The JAX module also returns three empty attention lists; this one
    returns the log-probabilities alone.
    """

    INPUTS = ("audio", "visual", "text")
    ATTENTIONS = ()

    def __init__(self, n_classes: int = 6, dropout: float = 0.2, D_h: int = 100,
                 gen_dropout: float = 0.2, gen_num_layers: int = 8, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.n_classes, self.D_h, self.gen_num_layers = n_classes, D_h, gen_num_layers
        self.dropout = dropout  # unused in the forward, as in the reference
        kw = dict(generator=generator, device=device)
        self.acoustic_generator = AcousticGenerator(D_h, gen_dropout, gen_num_layers, **kw)
        self.visual_generator = VisualGenerator(D_h, gen_dropout, gen_num_layers, **kw)
        self.text_generator = TextGenerator(D_h, gen_dropout, gen_num_layers, **kw)
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

    def __init__(self, D_m: int = 100, D_g: int = 500, D_p: int = 500, D_e: int = 100,
                 D_h: int = 100, D_a: int = 100, n_classes: int = 6,
                 listener_state: bool = False, context_attention: str = "general",
                 dropout_rec: float = 0.1, dropout: float = 0.6, gen_dropout: float = 0.2,
                 gen_num_layers: int = 8, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.n_classes, self.gen_num_layers = n_classes, gen_num_layers
        kw = dict(generator=generator, device=device)
        self.acoustic_generator = AcousticGenerator(D_h, gen_dropout, gen_num_layers, **kw)
        self.visual_generator = VisualGenerator(D_h, gen_dropout, gen_num_layers, **kw)
        self.text_generator = TextGenerator(D_h, gen_dropout, gen_num_layers, **kw)
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
