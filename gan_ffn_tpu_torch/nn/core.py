"""Core building blocks (counterpart of ``gan_ffn_tpu/nn/core.py``).

Initialisation follows torch's defaults, as the JAX package reproduces them:
``Linear`` weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the packed
attention ``in_proj`` xavier-uniform with a zero bias.  Parameters are drawn
on the CPU from an explicit ``torch.Generator`` and then moved to ``device``,
so one seed gives the same weights on every device.  No bit match with the
JAX init is sought: ``utils/weights.py`` carries JAX weights across.

Modules that launch a kernel with dropout draw one seed per call from their
``dropout_generator``, a CPU ``torch.Generator`` that the trainer owns
(:func:`set_dropout_generator`), or from torch's default CPU generator when
it is None.  The draw stays on the host, so it never waits on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Point every kernel-launching submodule of ``module`` at ``generator``
    for its kernel dropout seeds (the counterpart of the JAX modules'
    ``make_rng("dropout")``)."""
    for m in module.modules():
        if hasattr(m, "dropout_generator"):
            m.dropout_generator = generator


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch's ``F.gelu`` default."""
    return F.gelu(x)


def uniform_parameter(
    shape: Sequence[int],
    bound: float,
    generator: Optional[torch.Generator],
    device,
) -> nn.Parameter:
    """A float32 parameter drawn from U(-bound, bound) on the CPU, then moved."""
    t = torch.empty(tuple(shape), dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t.to(device))


class Linear(nn.Module):
    """``torch.nn.Linear`` with its default init drawn from ``generator``:
    ``weight (out, in)``, ``bias (out,)`` (None with ``bias=False``),
    y = x W^T + b."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = uniform_parameter((out_features, in_features), bound, generator, device)
        self.bias = uniform_parameter((out_features,), bound, generator, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def kernel_layout(linear: Linear):
    """``(W^T, b)`` of a :class:`Linear`, with ``W^T (in, out)`` contiguous: the
    layout ``ops.mlp.fused_mlp`` takes.  A copy per call (e.g. 1.6 MB for a
    100->2048 layer), which keeps the weights in torch's layout in the
    ``state_dict``."""
    return linear.weight.t().contiguous(), linear.bias


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5, statistics in float32."""

    def __init__(self, features: int, eps: float = 1e-5, *, device="cuda"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)
