"""Graphed stage A: ``cli.common.make_stage_a_step(cfg, state, epoch_fused=True)``,
which is ``train.gan.make_gan_epoch_step`` under ``ShapeGraphs`` mode
``stage_a``, fed ``train.loop.batch_to_tensors`` batches as
``cli.common.train_gan`` feeds it (``gan_batch_from``)."""

from __future__ import annotations

from typing import List

import torch
from gan_ffn_tpu_torch.cli.common import gan_batch_from, make_stage_a_step
from gan_ffn_tpu_torch.train.gan import (GANConfig, GANState, create_gan_modules,
                                         create_gan_optimizers)
from gan_ffn_tpu_torch.train.loop import batch_to_tensors

from ..lib import flops
from ..reference import gan_ffn as ref
from . import base
from .train import TrainEntry


class Entry(TrainEntry):
    work = staticmethod(flops.stage_a)  # a step's model FLOPs and kernel launches
    kind = "stage_a"

    def make_state(self) -> None:
        cfg, device = self.cfg, self.device
        g = cfg["gan"]
        self.gcfg = GANConfig(D_h=cfg["D_h"], dropout=cfg["dropout"],
                              num_layers=cfg["num_layers"], lr=g["lr"], b1=g["b1"], b2=g["b2"])
        self.modules = create_gan_modules(self.gcfg, None, device)
        self.named = [(f"{net}.{k}", p) for net, m in self.modules.items()
                      for k, p in m.named_parameters()]
        self.leaves = [(n, tuple(p.shape)) for n, p in self.named]
        self.groups = [n.split(".", 1)[0] for n, _ in self.named]
        self.opts = create_gan_optimizers(self.gcfg, self.modules)
        self.step = None

    def build(self) -> None:
        self.step = make_stage_a_step(self.gcfg, GANState(self.modules, self.opts),
                                      epoch_fused=True)

    def feed(self, hb):
        return gan_batch_from(batch_to_tensors(base.port_batch(hb), self.device, seed=hb.seed))

    def run(self, tensors):
        return self.step(tensors)

    @staticmethod
    def losses(out) -> torch.Tensor:
        return torch.stack([out[f"duel_{i}"] for i in range(12)])

    @staticmethod
    def preds(out):
        return None

    def grad_norms(self) -> torch.Tensor:
        """Each leaf's Adam first moment, after the first step."""
        params = {id(p): opt for opt in self.opts.values()
                  for group in opt.param_groups for p in group["params"]}
        norms = []
        for _, p in self.named:
            state = params[id(p)].state.get(p, {})
            m = state.get("exp_avg")
            norms.append(m.norm() if m is not None else torch.zeros((), device=p.device))
        return torch.stack(norms)

    def params(self) -> List[torch.Tensor]:
        return [p for _, p in self.named]

    def graphs(self):
        return [self.step.graphs] if self.step is not None and self.step.graphs else []

    def free_state(self) -> None:
        self.step = self.opts = self.modules = self.named = None

    # ---- the reference ----------------------------------------------------
    def ref_begin(self, weights) -> None:
        self.ref_params = ref.split_weights(weights)
        self.ref_adams = ref.make_adams(self.ref_params, self.cfg)

    def ref_step(self, hb, fault: str = ""):
        batch = base.reference_batch(hb, self.device)
        return torch.stack(ref.stage_a_step(self.ref_params, self.ref_adams, batch, self.cfg,
                                            fault)), None

    def ref_grad_norms(self) -> torch.Tensor:
        return torch.stack([self.ref_adams[n.split(".", 1)[0]].m[n.split(".", 1)[1]].norm()
                            for n, _ in self.leaves])

    def ref_values(self) -> List[torch.Tensor]:
        return [self.ref_params[n.split(".", 1)[0]][n.split(".", 1)[1]] for n, _ in self.leaves]
