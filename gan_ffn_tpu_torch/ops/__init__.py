"""Kernel wrappers: hand-written CUDA on the card, plain PyTorch on the CPU.
The kernels run wherever the tensors are on the card: there is no switch
that turns them off (the JAX package's ``ops/config.py``)."""

from .attention import fused_attention
from .mlp import fused_mlp

__all__ = ["fused_attention", "fused_mlp"]
