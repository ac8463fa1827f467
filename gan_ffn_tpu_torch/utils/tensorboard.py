"""Optional TensorBoard logging (counterpart of
``gan_ffn_tpu/utils/tensorboard.py``; reference ``--tensorboard``,
train_IEMOCAP.py:508-511, 702-704).

The trainers log ``test: accuracy/loss`` and ``train: accuracy/loss`` per
epoch and one histogram per parameter gradient: by default one sampled
batch's gradients per epoch (``train.classifier.make_grad_fn``), or with
``--tb-grad-histograms batch`` the gradients of every step, as the
reference logs them (train_IEMOCAP.py:166-168), through the epoch loop's
``on_batch`` hook.  Histogram tags are the module's ``named_parameters()``
names.  :class:`TBWriter` writes through
``torch.utils.tensorboard.SummaryWriter`` where that imports (it needs the
``tensorboard`` package), and is a no-op otherwise (``enabled`` False).
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch
from torch import nn


class TBWriter:
    def __init__(self, logdir: str = "./tensorboard", enabled: bool = True):
        self._writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(logdir)
        except Exception:  # noqa: BLE001 (no tensorboard package: log nothing)
            self._writer = None

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        if self._writer is not None:
            if isinstance(values, torch.Tensor):
                values = values.detach().float().cpu().numpy()
            self._writer.add_histogram(tag, np.asarray(values).ravel(), step)

    def add_param_histograms(self, grads: Union[nn.Module, Mapping[str, torch.Tensor]],
                             step: int, prefix: str = "") -> None:
        """One histogram per entry of ``grads`` (name -> gradient), or per
        parameter of a module that has a ``.grad``, tagged ``prefix + name``."""
        if self._writer is None:
            return
        if isinstance(grads, nn.Module):
            grads = {n: p.grad for n, p in grads.named_parameters() if p.grad is not None}
        for name, grad in grads.items():
            self.add_histogram(prefix + name, grad, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
