"""Models ported so far: the three generators, the three discriminators
and the GAN_FFN classifier."""

from .discriminators import AcousticDiscriminator, TextDiscriminator, VisualDiscriminator
from .gan_ffn import GAN_FFN
from .generators import AcousticGenerator, TextGenerator, VisualGenerator

__all__ = [
    "GAN_FFN",
    "AcousticDiscriminator",
    "AcousticGenerator",
    "TextDiscriminator",
    "TextGenerator",
    "VisualDiscriminator",
    "VisualGenerator",
]
