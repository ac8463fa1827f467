"""Core building blocks (counterpart of ``gan_ffn_tpu/nn/core.py``).

Initialisation follows torch's defaults, as the JAX package reproduces them:
``Linear`` weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the packed
attention ``in_proj`` xavier-uniform with a zero bias.  Parameters are drawn
on the CPU from an explicit ``torch.Generator`` and then moved to ``device``,
so one seed gives the same weights on every device.  No bit match with the
JAX init is sought: ``utils/weights.py`` carries JAX weights across.

Modules that launch a kernel with dropout take each call's seed from their
``dropout_seeds``, an ``ops.dropout.StepSeeds`` that the trainer owns and
sets on all of its modules (:func:`set_dropout_generator`): inside a train
step the k-th call gets the step's device base and ``k``, outside one a
fresh host seed from the trainer's CPU generator (torch's default CPU
generator where none is set).  No draw waits on the card.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import Seed, StepSeeds


def set_dropout_generator(module: nn.Module,
                          source: Union[StepSeeds, torch.Generator, None]) -> StepSeeds:
    """Point every kernel-launching submodule of ``module`` at one seed
    source for its kernel dropout seeds (the counterpart of the JAX modules'
    ``make_rng("dropout")``): ``source`` itself where it is a
    :class:`StepSeeds`, else a new one over the generator ``source``.
    Returns it; hand it to the next module for one source across several."""
    seeds = source if isinstance(source, StepSeeds) else StepSeeds(source)
    for m in module.modules():
        if hasattr(m, "dropout_seeds"):
            m.dropout_seeds = seeds
    return seeds


def kernel_seed(module: nn.Module) -> Seed:
    """The seed of ``module``'s next kernel call that draws a mask."""
    seeds = module.dropout_seeds
    return seeds.next() if seeds is not None else StepSeeds().next()


def dropout_seeds_of(modules: Iterable[nn.Module]) -> StepSeeds:
    """The one seed source that ``modules`` share, set on all of them as a
    new :class:`StepSeeds` over torch's default CPU generator where none of
    them has one.  Raises where they hold two: a step numbers its calls in
    one source."""
    modules = list(modules)
    found = {id(m.dropout_seeds): m.dropout_seeds for module in modules for m in module.modules()
             if getattr(m, "dropout_seeds", None) is not None}
    if len(found) > 1:
        raise ValueError("the modules draw from several seed sources: set one StepSeeds on all")
    seeds = next(iter(found.values())) if found else StepSeeds()
    for module in modules:
        set_dropout_generator(module, seeds)
    return seeds


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
