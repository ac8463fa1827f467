"""Models ported so far: the three generators, the three discriminators,
the GAN_FFN and GAN_FFN_DialogueRNN classifiers, the DialogueRNN modules
(``dialogue_rnn``) and the MELD entry point's ``MELDLSTMModel``
(``baselines``)."""

from .baselines import MELDLSTMModel
from .discriminators import AcousticDiscriminator, TextDiscriminator, VisualDiscriminator
from .dialogue_rnn import BiModel, DialogueRNN
from .gan_ffn import GAN_FFN, GAN_FFN_DialogueRNN
from .generators import AcousticGenerator, TextGenerator, VisualGenerator

__all__ = [
    "GAN_FFN",
    "GAN_FFN_DialogueRNN",
    "BiModel",
    "DialogueRNN",
    "MELDLSTMModel",
    "AcousticDiscriminator",
    "AcousticGenerator",
    "TextDiscriminator",
    "TextGenerator",
    "VisualDiscriminator",
    "VisualGenerator",
]
