"""The models: the three generators, the three discriminators, the GAN_FFN
and GAN_FFN_DialogueRNN classifiers, the DialogueRNN modules
(``dialogue_rnn``: ``DialogueRNN``, ``BiModel``, ``BiE2EModel``) and the
baselines (``baselines``: the MELD entry point's ``MELDLSTMModel`` and the
library-only eight)."""

from .baselines import (
    CNN,
    CNNFeatureExtractor,
    E2ELSTMModel,
    Emoformer,
    FullyConnection,
    LSTMModel,
    LSTMModel2,
    MELDLSTMModel,
    TextCNN,
)
from .dialogue_rnn import BiE2EModel, BiModel, DialogueRNN
from .discriminators import AcousticDiscriminator, TextDiscriminator, VisualDiscriminator
from .gan_ffn import GAN_FFN, GAN_FFN_DialogueRNN
from .generators import AcousticGenerator, TextGenerator, VisualGenerator

__all__ = [
    "AcousticDiscriminator",
    "AcousticGenerator",
    "BiE2EModel",
    "BiModel",
    "CNN",
    "CNNFeatureExtractor",
    "DialogueRNN",
    "E2ELSTMModel",
    "Emoformer",
    "FullyConnection",
    "GAN_FFN",
    "GAN_FFN_DialogueRNN",
    "LSTMModel",
    "LSTMModel2",
    "MELDLSTMModel",
    "TextCNN",
    "TextDiscriminator",
    "TextGenerator",
    "VisualDiscriminator",
    "VisualGenerator",
]
