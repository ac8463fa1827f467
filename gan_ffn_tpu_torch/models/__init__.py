"""Models ported so far: the three generators, the three discriminators,
the GAN_FFN and GAN_FFN_DialogueRNN classifiers, and the DialogueRNN
modules (``dialogue_rnn``)."""

from .discriminators import AcousticDiscriminator, TextDiscriminator, VisualDiscriminator
from .dialogue_rnn import BiModel, DialogueRNN
from .gan_ffn import GAN_FFN, GAN_FFN_DialogueRNN
from .generators import AcousticGenerator, TextGenerator, VisualGenerator

__all__ = [
    "GAN_FFN",
    "GAN_FFN_DialogueRNN",
    "BiModel",
    "DialogueRNN",
    "AcousticDiscriminator",
    "AcousticGenerator",
    "TextDiscriminator",
    "TextGenerator",
    "VisualDiscriminator",
    "VisualGenerator",
]
