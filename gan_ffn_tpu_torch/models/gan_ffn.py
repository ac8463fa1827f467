"""The flagship fusion classifier ``GAN_FFN`` (counterpart of
``gan_ffn_tpu/models/gan_ffn.py::GAN_FFN``): the three generators' outputs
are summed and classified per utterance by one linear head and a float32
log-softmax.  The DialogueRNN classifier is not ported yet, and this module
does not import it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.core import Linear
from .generators import AcousticGenerator, TextGenerator, VisualGenerator


class GAN_FFN(nn.Module):
    """(acoustic (L,B,100), visual (L,B,512), text (L,B,100)) ->
    log_prob (L,B,n_classes) float32.

    The JAX module also returns three empty attention lists; this one
    returns the log-probabilities alone.
    """

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
                valid_len: Optional[int] = None) -> torch.Tensor:
        fusion = (
            self.acoustic_generator(acoustic, valid_len=valid_len)
            + self.visual_generator(visual, valid_len=valid_len)
            + self.text_generator(text, valid_len=valid_len)
        )
        return torch.log_softmax(self.fc(fusion).float(), dim=2)
