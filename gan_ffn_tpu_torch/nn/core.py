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


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """``x * relu6(x + 3) / 6``, op by op as the JAX package writes it (each
    op rounded to ``x``'s dtype), so that bf16 gives the JAX bits; torch's
    ``F.hardswish`` rounds elsewhere."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


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


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x W^T + b`` at the compute ``dtype`` (default ``x``'s), as the JAX
    package's ``TorchLinear`` computes it: x, W and b cast to the dtype at
    use, the product (f32 sums) rounded to it, then the bias added at it.
    In float32 one ``F.linear``, its bias fused into the product."""
    dtype = dtype or x.dtype
    if dtype == x.dtype == weight.dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class Linear(nn.Module):
    """``torch.nn.Linear`` with its default init drawn from ``generator``:
    ``weight (out, in)``, ``bias (out,)`` (None with ``bias=False``),
    y = x W^T + b at the compute ``dtype`` (None: the input's; see
    :func:`linear`).  The parameters are float32 whatever the compute dtype,
    as in the JAX package, unless the module is cast (``serving.bf16_variant``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.dtype = dtype
        self.weight = uniform_parameter((out_features, in_features), bound, generator, device)
        self.bias = uniform_parameter((out_features,), bound, generator, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.dtype)


class Embedding(nn.Module):
    """A token embedding, ``weight (num, dim)`` drawn from N(0, 1) as
    ``torch.nn.Embedding``'s: ids of any shape -> ``(..., dim)``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        w = torch.empty(num_embeddings, embedding_dim).normal_(0.0, 1.0, generator=generator)
        self.weight = nn.Parameter(w.to(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight)


def conv(cls: type, in_channels: int, out_channels: int, kernel_size: Sequence[int], *,
         generator: Optional[torch.Generator] = None, device="cuda") -> nn.Module:
    """A ``torch.nn.Conv1d`` or ``Conv2d`` (``cls``), stride 1, no padding
    (flax's ``VALID``), with torch's default init drawn from ``generator``:
    weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = in_channels
    * prod(kernel_size)."""
    kernel_size = tuple(kernel_size)
    layer = cls(in_channels, out_channels, kernel_size, device="meta")
    bound = 1.0 / math.sqrt(in_channels * math.prod(kernel_size))
    layer.weight = uniform_parameter((out_channels, in_channels, *kernel_size), bound,
                                     generator, device)
    layer.bias = uniform_parameter((out_channels,), bound, generator, device)
    return layer


def kernel_layout(layer: Linear, dtype: Optional[torch.dtype] = None):
    """``(W^T, b)`` of a :class:`Linear` at the compute ``dtype`` (default
    the parameters'), with ``W^T (in, out)`` contiguous: the layout
    ``ops.mlp.fused_mlp`` takes.  A copy per call (e.g. 1.6 MB for a
    100->2048 layer), which keeps the weights in torch's layout in the
    ``state_dict``."""
    w, b = layer.weight, layer.bias
    if dtype is not None:
        w, b = w.to(dtype), b.to(dtype)
    return w.t().contiguous(), b


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5, statistics, scale and bias in
    float32, the result at the compute ``dtype`` (None: the input's)."""

    def __init__(self, features: int, eps: float = 1e-5, *, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.dtype or x.dtype)
