"""``torch_adam`` (counterpart of ``gan_ffn_tpu/train/optim.py``).

The JAX package rebuilds ``torch.optim.Adam`` from optax parts: the L2 term
``weight_decay * param`` is added to the gradient BEFORE the moments (coupled
L2, not AdamW), and bias correction and eps placement follow torch.  Here
that is ``torch.optim.Adam`` itself.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


def torch_adam(
    params: Iterable[torch.nn.Parameter],
    lr: float,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
