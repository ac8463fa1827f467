"""Building blocks: Linear, LayerNorm, embeddings and convolutions, the
positional encoding, the Transformer encoder, the attentions, the GRU and
LSTM, and the losses."""

from .attention import Attention, MatchingAttention, SimpleAttention, matching
from .core import Embedding, LayerNorm, Linear, gelu, hardswish
from .losses import (
    bce_loss,
    focal_loss,
    masked_mse_loss,
    masked_nll_loss,
    unmasked_weighted_nll_loss,
)
from .positional import PositionalEncoding, sinusoidal_table
from .recurrent import GRU, LSTM, GRUCell, LSTMCell
from .transformer import MultiheadSelfAttention, TransformerEncoder, TransformerEncoderLayer

__all__ = [
    "Attention",
    "Embedding",
    "GRU",
    "GRUCell",
    "LSTM",
    "LSTMCell",
    "LayerNorm",
    "Linear",
    "MatchingAttention",
    "MultiheadSelfAttention",
    "PositionalEncoding",
    "SimpleAttention",
    "TransformerEncoder",
    "TransformerEncoderLayer",
    "bce_loss",
    "focal_loss",
    "gelu",
    "hardswish",
    "masked_mse_loss",
    "masked_nll_loss",
    "matching",
    "sinusoidal_table",
    "unmasked_weighted_nll_loss",
]
