"""Building blocks: Linear, LayerNorm, positional encoding, Transformer encoder, losses."""
