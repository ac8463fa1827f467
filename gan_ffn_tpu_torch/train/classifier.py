"""Classifier train and eval steps (counterpart of
``gan_ffn_tpu/train/classifier.py``; reference train_or_eval_model,
train_IEMOCAP.py:103-197).

A train step runs the forward, the masked NLL on the batch-first flattened
log-probabilities, the backward and one Adam update, and returns the loss
and the per-utterance argmax predictions as device tensors: the epoch loop
fetches them once per epoch.  After a train step every parameter's ``.grad``
holds the gradient that the update applied.

Learning-rate quirk kept from the reference: it re-creates a
``LambdaLR(0.98**epoch)`` inside the batch loop, so every update uses the
base lr (a constant schedule).  ``train_step(batch, lr_scale)`` takes the
scale of the "decay" schedule instead; it sets each group's lr to
``initial_lr * lr_scale`` before the update, which scales the final update
as the JAX step does.

``graft_generator_params`` moves adversarially trained generators into a
classifier's ``state_dict``, by key prefix.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..nn.losses import masked_nll_loss

GENERATOR_KEYS = ("acoustic_generator", "visual_generator", "text_generator")
# the same generators under their stage-A names (gan_ffn_tpu/train/gan.py GEN_NAMES)
GENERATOR_GAN_KEYS = ("acoustic_gen", "visual_gen", "text_gen")


def graft_generator_params(
    classifier_state: Mapping[str, torch.Tensor], gan_state: Mapping[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """A copy of ``classifier_state`` whose ``acoustic_generator.*``,
    ``visual_generator.*`` and ``text_generator.*`` entries are taken from
    ``gan_state``'s ``acoustic_gen.*``, ``visual_gen.*`` and ``text_gen.*``."""
    out = dict(classifier_state)
    for clf_key, gan_key in zip(GENERATOR_KEYS, GENERATOR_GAN_KEYS):
        for name in classifier_state:
            if name.startswith(clf_key + "."):
                source = gan_key + name[len(clf_key):]
                if source not in gan_state:
                    raise KeyError(f"{source} is missing from the GAN state")
                out[name] = gan_state[source]
    return out


def loss_and_preds(
    log_prob: torch.Tensor,
    batch: Mapping,
    n_classes: int,
    loss_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked NLL and argmax over ``log_prob (L, B, C)`` transposed
    batch-first and flattened to ``(B*L, C)``, as the reference does."""
    lp = log_prob.transpose(0, 1).reshape(-1, n_classes)
    loss = masked_nll_loss(lp, batch["label"].reshape(-1), batch["umask"], loss_weights)
    return loss, lp.argmax(dim=1)


def make_classifier_steps(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    n_classes: int,
    loss_weights: Optional[torch.Tensor] = None,
    deterministic: bool = False,
) -> Tuple[Callable, Callable]:
    """``(train_step, eval_step)`` over batches of ``train.loop.batch_to_tensors``.

    ``train_step(batch, lr_scale=1.0) -> (loss, preds)`` updates ``model``
    in place; it runs the model in training mode (every dropout on) unless
    ``deterministic``.  ``eval_step(batch) -> (loss, preds)`` runs it in
    eval mode without gradients.
    """
    for group in optimizer.param_groups:
        group.setdefault("initial_lr", group["lr"])

    def forward(batch):
        return model(batch["audio"], batch["visual"], batch["text"], valid_len=batch["valid_len"])

    def train_step(batch, lr_scale: float = 1.0):
        model.train(not deterministic)
        loss, preds = loss_and_preds(forward(batch), batch, n_classes, loss_weights)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = group["initial_lr"] * lr_scale
        optimizer.step()
        return loss.detach(), preds

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        return loss_and_preds(forward(batch), batch, n_classes, loss_weights)

    return train_step, eval_step
