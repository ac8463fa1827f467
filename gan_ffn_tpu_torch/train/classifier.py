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
``initial_lr * lr_scale`` before the update (``train.optim.set_lr_scale``,
in place on a card), which scales the final update as the JAX step does.

The steps serve the three classifiers: a model's ``INPUTS`` names the
batch entries it takes (``audio``, ``visual``, ``text`` for ``GAN_FFN``;
with ``qmask`` and ``umask`` for ``GAN_FFN_DialogueRNN``; ``text``,
``qmask``, ``umask`` for ``MELDLSTMModel``), and its
``ATTENTIONS`` the attention weights that follow the log-probabilities in
its output, which the eval step returns (the reference accumulates them on
eval epochs, train_IEMOCAP_DialogueRNN.py:173-176).

A train step draws one dropout seed base per batch from the model's seed
source (``ops.dropout.StepSeeds``), unless the batch carries it as
``seed``, as ``train.loop.run_epoch_fused`` hands it over.
:func:`make_classifier_epoch_steps` gives the same steps, each dispatched
through ``train.graphs.ShapeGraphs``: one CUDA graph per batch shape on a
card, eager on the CPU.

``graft_generator_params`` moves adversarially trained generators into a
classifier's ``state_dict``, by key prefix.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..nn.core import dropout_seeds_of
from ..nn.losses import masked_nll_loss
from .graphs import ShapeGraphs
from .optim import make_capturable, set_lr_scale

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

    ``train_step(batch, lr_scale=None) -> (loss, preds)`` updates ``model``
    in place; it runs the model in training mode (every dropout on) unless
    ``deterministic``.  ``eval_step(batch)`` runs it in eval mode without
    gradients and returns ``(loss, preds)``, or ``(loss, preds, attentions)``
    for a model with ``ATTENTIONS``: a dict of its attention weights.
    ``train_step.seeds`` is the seed source it draws from (None where
    ``deterministic``, or where no module of ``model`` launches a kernel).
    """
    return _steps(model, optimizer, n_classes, loss_weights, deterministic, graphed=False)


def make_classifier_epoch_steps(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    n_classes: int,
    loss_weights: Optional[torch.Tensor] = None,
    deterministic: bool = False,
) -> Tuple[Callable, Callable]:
    """The steps of :func:`make_classifier_steps` for ``train.loop.run_epoch_fused``
    (counterpart of ``gan_ffn_tpu/train/classifier.py::make_classifier_epoch_steps``),
    each dispatched through its own ``train.graphs.ShapeGraphs`` (modes
    ``train`` and ``eval``), which ``train_step.graphs`` and
    ``eval_step.graphs`` hold.  On a card ``optimizer`` is made capturable
    in place (``train.optim.make_capturable``)."""
    return _steps(model, optimizer, n_classes, loss_weights, deterministic, graphed=True)


def _steps(model, optimizer, n_classes, loss_weights, deterministic, graphed):
    for group in optimizer.param_groups:
        if "initial_lr" not in group:
            group["initial_lr"] = float(group["lr"])
    # a model none of whose modules launches a kernel with dropout (the MELD
    # model: every dropout is torch's own) needs no seed source
    draws = any(hasattr(m, "dropout_seeds") for m in model.modules())
    seeds = None if deterministic or not draws else dropout_seeds_of([model])
    if graphed and next(model.parameters()).device.type == "cuda":
        make_capturable(optimizer)

    def forward(batch):
        """The model's log-probabilities and its attention weights (a tuple,
        empty for ``GAN_FFN``)."""
        out = model(*(batch[k] for k in model.INPUTS), valid_len=batch["valid_len"])
        return (out[0], out[1:]) if model.ATTENTIONS else (out, ())

    def train_body(batch):
        model.train(not deterministic)
        with seeds.step(batch.get("seed")) if seeds is not None else contextlib.nullcontext():
            loss, preds = loss_and_preds(forward(batch)[0], batch, n_classes, loss_weights)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        return loss.detach(), preds

    @torch.no_grad()
    def eval_body(batch):
        model.eval()
        log_prob, attentions = forward(batch)
        loss, preds = loss_and_preds(log_prob, batch, n_classes, loss_weights)
        if not model.ATTENTIONS:
            return loss, preds
        return loss, preds, dict(zip(model.ATTENTIONS, attentions))

    train_run = ShapeGraphs(train_body, "train") if graphed else train_body
    eval_run = ShapeGraphs(eval_body, "eval") if graphed else eval_body

    def train_step(batch, lr_scale: Optional[float] = None):
        if lr_scale is not None:
            set_lr_scale(optimizer, lr_scale)
        if seeds is not None and "seed" not in batch:
            batch = {**batch, "seed": seeds.draw_tensor(batch["label"].device)}
        return train_run(batch)

    def eval_step(batch):
        return eval_run(batch)

    train_step.seeds = seeds
    train_step.graphs = train_run if graphed else None
    eval_step.graphs = eval_run if graphed else None
    return train_step, eval_step

