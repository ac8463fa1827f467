"""Models ported so far: the three generators and the GAN_FFN classifier."""

from .gan_ffn import GAN_FFN
from .generators import AcousticGenerator, TextGenerator, VisualGenerator

__all__ = ["GAN_FFN", "AcousticGenerator", "TextGenerator", "VisualGenerator"]
