"""Random weights from ``--seed``, made on the device in one draw.

The leaves are named and shaped as the port's modules name them (torch's
own conventions).  One uniform draw covers every leaf; each leaf takes its
slice, scaled by torch's default bound for its fan-in: U(-1/sqrt(fan_in),
1/sqrt(fan_in)), where fan_in is a matrix's last axis and a vector's length.
LayerNorm scales are 1 and shifts 0.  The same seed gives the same weights,
so the reference draws them again after the window instead of keeping a
copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Leaves = List[Tuple[str, Tuple[int, ...]]]


def _is_norm(name: str) -> bool:
    return ".norm" in name or name.startswith("norm")


def draw(leaves: Leaves, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``leaves`` (name, shape), float32 on ``device``."""
    sizes = [math.prod(shape) for _, shape in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out = {}
    for (name, shape), piece in zip(leaves, torch.split(flat, sizes)):
        if _is_norm(name):
            fill = 1.0 if name.endswith("weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
        else:
            out[name] = piece.view(shape).mul_(1.0 / math.sqrt(shape[-1]))
    return out


@torch.no_grad()
def load(named: Sequence[Tuple[str, torch.Tensor]], weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the parameters ``named``."""
    for name, p in named:
        p.copy_(weights[name])
