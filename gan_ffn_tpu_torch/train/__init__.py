"""Training: stage A (the adversarial engine), stage B (the classifier
steps and the epoch loop) and the optimizer.  The classifier's state is
its module and its ``torch.optim.Adam``; there is no ``ClassifierState``."""

from .classifier import make_classifier_epoch_steps, make_classifier_steps
from .gan import (
    LOGGED_LOSS_KEYS,
    GANConfig,
    GANState,
    create_gan_modules,
    init_gan_state,
    make_gan_epoch_step,
    make_gan_train_step,
)
from .loop import EpochResult, run_epoch, run_epoch_fused
from .optim import torch_adam

__all__ = [
    "EpochResult",
    "GANConfig",
    "GANState",
    "LOGGED_LOSS_KEYS",
    "create_gan_modules",
    "init_gan_state",
    "make_classifier_epoch_steps",
    "make_classifier_steps",
    "make_gan_epoch_step",
    "make_gan_train_step",
    "run_epoch",
    "run_epoch_fused",
    "torch_adam",
]
