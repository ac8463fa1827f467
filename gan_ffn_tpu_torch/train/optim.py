"""``torch_adam`` (counterpart of ``gan_ffn_tpu/train/optim.py``).

The JAX package rebuilds ``torch.optim.Adam`` from optax parts: the L2 term
``weight_decay * param`` is added to the gradient BEFORE the moments (coupled
L2, not AdamW), and bias correction and eps placement follow torch.  Here
that is ``torch.optim.Adam`` itself.

A CUDA graph can record ``step()`` only of a capturable Adam, whose step
counts and lr live in device tensors: :func:`make_capturable` turns an Adam
on the card so, and the epoch-fused steps (``train/graphs.py``) call it.
The per-batch steps keep the plain Adam: a capturable one launches a kernel
per parameter for each of its bias-correction terms, 2,565 more kernels per
stage-A step on the H100 (PERF.md §5), which an eager step would enqueue.
:func:`set_lr_scale` changes the lr in place where it is a tensor, between
replays.  Each group keeps its starting lr as a float under ``initial_lr``.
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
    opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    for group in opt.param_groups:
        group["initial_lr"] = float(lr)
    return opt


def make_capturable(optimizer: torch.optim.Adam) -> torch.optim.Adam:
    """``optimizer`` (an Adam whose parameters lie on the card), in place,
    as a capturable Adam: each group's lr in a device tensor, its step
    counts on the device.  Its updates stay the same numbers."""
    for group in optimizer.param_groups:
        device = group["params"][0].device
        if device.type != "cuda":
            raise ValueError(f"a capturable Adam updates parameters on a card, not on {device}")
        if "initial_lr" not in group:
            group["initial_lr"] = float(group["lr"])
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = torch.tensor(float(group["lr"]), device=device)
        group["capturable"] = True
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(device=device, dtype=torch.float32)
    return optimizer


def set_lr_scale(optimizer: torch.optim.Optimizer, scale: float) -> None:
    """Every group's lr to ``initial_lr * scale``: in place where the lr is
    a tensor (a graph that recorded the update reads it there), else as a
    float."""
    for group in optimizer.param_groups:
        if "initial_lr" not in group:
            group["initial_lr"] = float(group["lr"])
        lr = group["initial_lr"] * scale
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
