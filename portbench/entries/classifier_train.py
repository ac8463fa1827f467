"""The graphed classifier train step:
``train.classifier.make_classifier_epoch_steps`` (the train step only) over
``GAN_FFN_DialogueRNN``, with ``train.optim.torch_adam`` and the IEMOCAP
class weights, fed ``train.loop.batch_to_tensors`` batches as
``train.loop.run_epoch_fused`` feeds it."""

from __future__ import annotations

from typing import List

import torch
from gan_ffn_tpu_torch.models import GAN_FFN_DialogueRNN
from gan_ffn_tpu_torch.train.classifier import make_classifier_epoch_steps
from gan_ffn_tpu_torch.train.loop import batch_to_tensors
from gan_ffn_tpu_torch.train.optim import torch_adam

from ..lib import flops
from ..reference import gan_ffn_dialoguernn as ref
from . import base
from .train import TrainEntry


class Entry(TrainEntry):
    work = staticmethod(flops.classifier)  # a step's model FLOPs and kernel launches
    kind = "classifier_train"

    def make_state(self) -> None:
        cfg, device = self.cfg, self.device
        c, o = cfg["dialoguernn"], cfg["optimizer"]
        self.model = GAN_FFN_DialogueRNN(
            D_m=cfg["D_h"], D_g=c["D_g"], D_p=c["D_p"], D_e=c["D_e"], D_h=c["D_h"],
            D_a=c["D_a"], n_classes=cfg["n_classes"], listener_state=c["listener_state"],
            context_attention=c["context_attention"], dropout_rec=c["dropout_rec"],
            dropout=c["dropout"], gen_dropout=cfg["dropout"], gen_num_layers=cfg["num_layers"],
            generator=None, device=device)
        self.named = list(self.model.named_parameters())
        self.leaves = [(n, tuple(p.shape)) for n, p in self.named]
        self.groups = ["model"] * len(self.named)
        self.opt = torch_adam(self.model.parameters(), o["lr"], (o["b1"], o["b2"]), o["eps"],
                              o["weight_decay"])
        self.step = None

    def build(self) -> None:
        weights = torch.tensor(self.cfg["class_weights"], device=self.device)
        self.step = make_classifier_epoch_steps(self.model, self.opt, self.cfg["n_classes"],
                                                weights)[0]

    def feed(self, hb):
        return batch_to_tensors(base.port_batch(hb), self.device, seed=hb.seed)

    def run(self, tensors):
        return self.step(tensors)

    @staticmethod
    def losses(out) -> torch.Tensor:
        return out[0].reshape(1)

    @staticmethod
    def preds(out):
        return out[1]

    def grad_norms(self) -> torch.Tensor:
        """Each leaf's gradient as Adam took it, from its first moment after one step."""
        b1 = self.cfg["optimizer"]["b1"]
        norms = []
        for _, p in self.named:
            m = self.opt.state.get(p, {}).get("exp_avg")
            norms.append(m.norm() / (1.0 - b1) if m is not None
                         else torch.zeros((), device=p.device))
        return torch.stack(norms)

    def params(self) -> List[torch.Tensor]:
        return [p for _, p in self.named]

    def graphs(self):
        return [self.step.graphs] if self.step is not None and self.step.graphs else []

    def free_state(self) -> None:
        self.step = self.opt = self.model = self.named = None

    # ---- the reference ----------------------------------------------------
    def ref_begin(self, weights) -> None:
        self.ref_params = ref.make_params(weights)
        self.ref_adam = ref.make_adam(self.ref_params, self.cfg)

    def ref_step(self, hb, fault: str = ""):
        batch = base.reference_batch(hb, self.device)
        loss, preds = ref.train_step(self.ref_params, self.ref_adam, batch, self.cfg, fault)
        return loss.reshape(1), preds

    def ref_grad_norms(self) -> torch.Tensor:
        b1 = self.cfg["optimizer"]["b1"]
        return torch.stack([self.ref_adam.m[n].norm() / (1.0 - b1) for n, _ in self.leaves])

    def ref_values(self) -> List[torch.Tensor]:
        return [self.ref_params[n] for n, _ in self.leaves]
