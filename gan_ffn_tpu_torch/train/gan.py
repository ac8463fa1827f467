"""Stage A, the adversarial engine (counterpart of ``gan_ffn_tpu/train/gan.py``;
reference train_GAN, train_IEMOCAP.py:200-393).

One train step runs the 12-duel round-robin ``DUEL_SCHEDULE`` eagerly, in
order: 6 discriminator duels and 6 generator duels, each one loss, one
gradient and one Adam update of the net it trains, so every duel sees the
updates of the duels before it.  Mode semantics, as the reference's:

- disc duel (train_disc, train_IEMOCAP.py:200-227): the discriminator in
  train mode; the generator in eval mode under ``torch.no_grad``, so the
  fake fusion is detached; loss ``(bce(real, 1) + bce(fake, 0)) / 2``, with
  real and fake as two passes of the discriminator;
- gen duel (train_gen, train_IEMOCAP.py:230-252): the generator in train
  mode, the discriminator in eval mode; loss ``bce(disc(gen(x)), 1)``.

Gradients are taken with respect to the trained net's parameters only
(``torch.autograd.grad``), so nothing reaches the opponent's ``.grad`` and
its next Adam step.  The BCE covers every (t, b) position of the
reference's dynamically padded batch: ``t < valid_len`` and ``b < n_real``
(:func:`duel_mask`), not ``umask``.  Per-network Adam: generators at ``lr``
(text at ``lr * 1.1``), discriminators at ``lr / 2``, betas ``(b1, b2)``
(train_IEMOCAP.py:292-297).  The loss dict keeps the reference's
duplicate-key overwrites: each logged key holds its last write
(``LOGGED_LOSS_KEYS``).

The JAX package compiles the schedule as one program or as twelve; in eager
torch both are this one loop.  :func:`make_gan_epoch_step` is the same step
for the epoch-fused stage A (``--epoch-fused``): one CUDA graph per batch
shape on a card (``train.graphs.ShapeGraphs``), eager on the CPU.  The six
networks share one dropout seed source (``ops.dropout.StepSeeds``), from
which a step draws one base per batch unless the batch carries it as
``seed``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import torch
from torch import nn

from ..models import (
    AcousticDiscriminator,
    AcousticGenerator,
    TextDiscriminator,
    TextGenerator,
    VisualDiscriminator,
    VisualGenerator,
)
from ..nn.core import dropout_seeds_of
from ..nn.losses import bce_loss
from .graphs import ShapeGraphs
from .optim import make_capturable, torch_adam

GEN_NAMES = ("acoustic_gen", "visual_gen", "text_gen")
DISC_NAMES = ("acoustic_disc", "visual_disc", "text_disc")

# The 12-duel schedule (train_IEMOCAP.py:355-382):
# (kind, net, real-input modality for the net, opponent, opponent's modality)
DUEL_SCHEDULE = (
    ("disc", "visual_disc", "visual", "acoustic_gen", "acoustic", "visual_D_loss"),
    ("gen", "acoustic_gen", "acoustic", "visual_disc", None, "acoustic_G_loss"),
    ("disc", "visual_disc", "visual", "text_gen", "text", "visual_D_loss"),
    ("gen", "text_gen", "text", "visual_disc", None, "text_G_loss"),
    ("disc", "text_disc", "text", "acoustic_gen", "acoustic", "text_D_loss"),
    ("gen", "acoustic_gen", "acoustic", "text_disc", None, "acoustic_G_loss"),
    ("disc", "acoustic_disc", "acoustic", "text_gen", "text", "acoustic_D_loss"),
    ("gen", "text_gen", "text", "acoustic_disc", None, "text_G_loss"),
    ("disc", "text_disc", "text", "visual_gen", "visual", "text_D_loss"),
    ("gen", "visual_gen", "visual", "text_disc", None, "visual_G_loss"),
    ("disc", "acoustic_disc", "acoustic", "visual_gen", "visual", "acoustic_D_loss"),
    ("gen", "visual_gen", "visual", "acoustic_disc", None, "visual_G_loss"),
)

# Reference loss-dict columns in CSV order (train_IEMOCAP.py:308-317); each key
# keeps only its LAST write in the schedule above.
LOGGED_LOSS_KEYS = (
    "acoustic_G_loss",
    "visual_G_loss",
    "text_G_loss",
    "visual_D_loss",
    "text_D_loss",
    "acoustic_D_loss",
)

# the batch tensor that carries each modality's real features
REAL_INPUTS = {"acoustic": "audio", "visual": "visual", "text": "text"}

_MODULES = {
    "acoustic_gen": AcousticGenerator,
    "visual_gen": VisualGenerator,
    "text_gen": TextGenerator,
    "acoustic_disc": AcousticDiscriminator,
    "visual_disc": VisualDiscriminator,
    "text_disc": TextDiscriminator,
}


@dataclasses.dataclass(frozen=True)
class GANConfig:
    D_h: int = 100
    dropout: float = 0.2
    num_layers: int = 8
    lr: float = 1e-4
    b1: float = 0.5
    b2: float = 0.6
    seed: int = 3407


class GANState(NamedTuple):
    """The six networks and their Adams, by name (``GEN_NAMES + DISC_NAMES``)."""

    modules: Dict[str, nn.Module]
    opts: Dict[str, torch.optim.Adam]


def create_gan_modules(cfg: GANConfig, generator: Optional[torch.Generator] = None,
                       device="cuda") -> Dict[str, nn.Module]:
    """The six networks, with weights drawn from ``generator`` (a CPU
    ``torch.Generator``) in the order of ``GEN_NAMES + DISC_NAMES``."""
    kw = dict(D_h=cfg.D_h, dropout=cfg.dropout, num_layers=cfg.num_layers,
              generator=generator, device=device)
    return {name: cls(**kw) for name, cls in _MODULES.items()}


def create_gan_optimizers(cfg: GANConfig,
                          modules: Mapping[str, nn.Module]) -> Dict[str, torch.optim.Adam]:
    """Per-network Adam: generators at lr (text lr * 1.1), discriminators at
    lr / 2, betas (b1, b2), no weight decay (train_IEMOCAP.py:292-297)."""
    lr = {name: cfg.lr for name in GEN_NAMES} | {name: cfg.lr / 2 for name in DISC_NAMES}
    lr["text_gen"] = cfg.lr * 1.1
    return {name: torch_adam(modules[name].parameters(), lr[name], (cfg.b1, cfg.b2))
            for name in GEN_NAMES + DISC_NAMES}


def init_gan_state(cfg: GANConfig, device="cuda") -> GANState:
    """Fresh networks (weights from ``cfg.seed``) and their Adams."""
    modules = create_gan_modules(cfg, torch.Generator().manual_seed(cfg.seed), device)
    return GANState(modules, create_gan_optimizers(cfg, modules))


def duel_mask(batch: Mapping) -> torch.Tensor:
    """(L, B, 1) float mask of the positions the reference's dynamically
    shaped BCE targets cover: ``t < valid_len`` and ``b < n_real`` (the
    batch's 0-d tensors on the device, or host ints)."""
    L, B = batch["text"].shape[:2]
    device = batch["text"].device
    t = torch.arange(L, device=device)[:, None] < batch["valid_len"]
    b = torch.arange(B, device=device)[None, :] < batch["n_real"]
    return (t & b).to(torch.float32)[:, :, None]


def make_gan_train_step(modules: Mapping[str, nn.Module], opts: Mapping[str, torch.optim.Adam],
                        deterministic: bool = False) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
    """``step(batch) -> losses`` over batches of ``train.loop.batch_to_tensors``
    (``text``, ``visual``, ``audio``, ``valid_len``, ``n_real``, and
    optionally ``seed``): the 12 duels, updating ``modules`` in place.
    ``losses`` maps ``duel_0`` .. ``duel_11`` and the six
    ``LOGGED_LOSS_KEYS`` to 0-d device tensors.

    ``deterministic`` runs every net in eval mode (no dropout), with the
    same gradients and updates.  After a step each parameter's ``.grad``
    holds the gradient of its net's last update.  ``step.seeds`` is the
    seed source the six networks share (None where ``deterministic``)."""
    return _gan_step(modules, opts, deterministic, graphed=False)


def make_gan_epoch_step(modules: Mapping[str, nn.Module], opts: Mapping[str, torch.optim.Adam],
                        deterministic: bool = False) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
    """The step of :func:`make_gan_train_step` for the epoch-fused stage A
    (counterpart of ``gan_ffn_tpu/train/gan.py::make_gan_epoch_step``),
    dispatched through ``train.graphs.ShapeGraphs`` (mode ``stage_a``),
    which ``step.graphs`` holds: on a card one graph per batch shape, the
    12 duels, their ``torch.autograd.grad`` and the twelve updates of the
    six Adams in it, made capturable in place (``train.optim.make_capturable``)."""
    return _gan_step(modules, opts, deterministic, graphed=True)


def _gan_step(modules, opts, deterministic, graphed):
    params = {name: list(m.parameters()) for name, m in modules.items()}
    seeds = None if deterministic else dropout_seeds_of(modules.values())
    if graphed:
        for name, opt in opts.items():
            if params[name][0].device.type == "cuda":
                make_capturable(opt)

    def update(net: str, loss: torch.Tensor) -> None:
        grads = torch.autograd.grad(loss, params[net])
        for p, g in zip(params[net], grads):
            p.grad = g
        opts[net].step()

    def body(batch: Mapping) -> Dict[str, torch.Tensor]:
        mask = duel_mask(batch)
        valid_len = batch["valid_len"]
        losses: Dict[str, torch.Tensor] = {}
        with seeds.step(batch.get("seed")) if seeds is not None else contextlib.nullcontext():
            for i, (kind, net, net_mod, opp, opp_mod, log_key) in enumerate(DUEL_SCHEDULE):
                trained, opponent = modules[net], modules[opp]
                trained.train(not deterministic)
                opponent.eval()
                real = batch[REAL_INPUTS[net_mod]]
                if kind == "disc":
                    real_prob = trained(real, valid_len=valid_len)
                    with torch.no_grad():
                        fake = opponent(batch[REAL_INPUTS[opp_mod]], valid_len=valid_len)
                    fake_prob = trained(fake, valid_len=valid_len)
                    loss = (bce_loss(real_prob, torch.ones_like(real_prob), mask)
                            + bce_loss(fake_prob, torch.zeros_like(fake_prob), mask)) / 2.0
                else:
                    prob = opponent(trained(real, valid_len=valid_len), valid_len=valid_len)
                    loss = bce_loss(prob, torch.ones_like(prob), mask)
                update(net, loss)
                losses[f"duel_{i}"] = losses[log_key] = loss.detach()
        return losses

    run = ShapeGraphs(body, "stage_a") if graphed else body

    def step(batch: Mapping) -> Dict[str, torch.Tensor]:
        if seeds is not None and "seed" not in batch:
            batch = {**batch, "seed": seeds.draw_tensor(batch["text"].device)}
        return run(batch)

    step.seeds = seeds
    step.graphs = run if graphed else None
    return step
