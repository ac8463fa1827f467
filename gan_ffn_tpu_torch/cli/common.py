"""Shared wiring of the training entry points (counterpart of
``gan_ffn_tpu/cli/common.py``): stage A's epoch loop.

The JAX package's epoch-fused branch (one program per epoch) is not ported:
its GPU counterpart is CUDA-graph capture (ROADMAP module note 12).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch

from ..data.loaders import Batch
from ..nn.core import set_dropout_generator
from ..train.gan import LOGGED_LOSS_KEYS, GANConfig, GANState, init_gan_state, make_gan_train_step
from ..train.loop import batch_to_tensors
from ..utils.artifacts import LossHistory, append_loss_row


def gan_batch_from(tensors: Mapping) -> Dict[str, object]:
    """The part of a ``train.loop.batch_to_tensors`` batch that stage A reads."""
    return {k: tensors[k] for k in ("text", "visual", "audio", "valid_len", "n_real")}


def train_gan(
    cfg: GANConfig,
    train_loader: Iterable[Batch],
    epochs: int,
    state: Optional[GANState] = None,
    history: Optional[LossHistory] = None,
    start_epoch: int = 0,
    device="cuda",
    log: Callable[[str], None] = print,
    log_every_batch: bool = True,
) -> Tuple[GANState, LossHistory]:
    """Adversarial pre-training (reference train_GAN, train_IEMOCAP.py:255-393):
    ``epochs`` epochs of the 12-duel step over ``train_loader``, numbered from
    ``start_epoch``.

    ``state`` defaults to :func:`train.gan.init_gan_state` on ``device``.
    The kernels' dropout seeds come from a CPU generator seeded with
    ``cfg.seed + 1``, set on all six networks.  The losses stay on the
    device until the epoch ends and come back in one copy; one row per epoch,
    the last batch's losses, is appended to ``history`` (the reference's CSV
    cadence)."""
    if state is None:
        state = init_gan_state(cfg, device)
    if history is None:
        history = []
    dropout_seeds = torch.Generator().manual_seed(cfg.seed + 1)
    for module in state.modules.values():
        set_dropout_generator(module, dropout_seeds)
    step = make_gan_train_step(state.modules, state.opts)

    log("=" * 15 + " start training GAN " + "=" * 15)
    for epoch in range(start_epoch, start_epoch + epochs):
        t0 = time.time()
        utterances = 0
        epoch_losses = []
        for batch in train_loader:
            losses = step(gan_batch_from(batch_to_tensors(batch, device)))
            utterances += batch.n_utterances
            epoch_losses.append(torch.stack([losses[k] for k in LOGGED_LOSS_KEYS]))
        if not epoch_losses:
            continue
        fetched = torch.stack(epoch_losses).cpu().tolist()  # one copy for the epoch
        dt = time.time() - t0
        if log_every_batch:
            for row in fetched:
                vals = " ".join(f"{k}={v:.4f}" for k, v in zip(LOGGED_LOSS_KEYS, row))
                log(f"GAN epoch {epoch} {vals}")
        append_loss_row(history, epoch, dict(zip(LOGGED_LOSS_KEYS, fetched[-1])))
        log(
            f"GAN epoch {epoch} done in {dt:.2f}s "
            f"({12 * utterances / max(dt, 1e-9):.1f} duel-utterances/sec)"
        )
    return state, history
