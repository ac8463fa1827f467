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

Where the port's tracing is on (``utils/profiling.py``), a train step's
forward and loss lie in the region ``gan_ffn.forward``, its backward in
``gan_ffn.backward`` and its Adam step in ``gan_ffn.optimizer``, and every
step in ``gan_ffn.step``.

``make_classifier_steps(..., dp=...)`` gives the data-parallel train step
(the library DP of the JAX package's mesh, ``parallel/mesh.py``): on the
whole batch it computes the masked NLL's global denominator, runs the
forward and backward on its rank's slice, sums the gradients over the group
between ``backward`` and the Adam step, and returns the summed loss and
every rank's predictions in batch order.  Its eval step runs the whole
batch on every rank.  Without a group the steps are the single-process
ones, bit for bit.

``graft_generator_params`` moves adversarially trained generators into a
classifier's ``state_dict``, by key prefix.  :func:`make_grad_fn` takes one
batch's gradients without an update, for ``--tensorboard``'s histograms.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..nn.core import dropout_seeds_of
from ..nn.losses import masked_nll_loss, nll_denominator
from ..ops.dropout import draw_seed, host_to_device
from ..parallel.mesh import (DataParallel, active, all_gather_cat, all_reduce_grads,
                             all_reduce_sum, shard_batch)
from ..utils import profiling
from .graphs import ShapeGraphs, in_step_region
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
    denominator: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked NLL and argmax over ``log_prob (L, B, C)`` transposed
    batch-first and flattened to ``(B*L, C)``, as the reference does
    (``denominator``: the whole batch's, under data parallelism)."""
    lp = log_prob.transpose(0, 1).reshape(-1, n_classes)
    loss = masked_nll_loss(lp, batch["label"].reshape(-1), batch["umask"], loss_weights,
                           denominator)
    return loss, lp.argmax(dim=1)


def make_classifier_steps(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    n_classes: int,
    loss_weights: Optional[torch.Tensor] = None,
    deterministic: bool = False,
    dp: Optional[DataParallel] = None,
) -> Tuple[Callable, Callable]:
    """``(train_step, eval_step)`` over batches of ``train.loop.batch_to_tensors``.

    ``train_step(batch, lr_scale=None) -> (loss, preds)`` updates ``model``
    in place; it runs the model in training mode (every dropout on) unless
    ``deterministic``.  ``eval_step(batch)`` runs it in eval mode without
    gradients and returns ``(loss, preds)``, or ``(loss, preds, attentions)``
    for a model with ``ATTENTIONS``: a dict of its attention weights.
    ``train_step.seeds`` is the seed source it draws from (None where
    ``deterministic``, or where no module of ``model`` launches a kernel).
    ``dp`` (``parallel.mesh.DataParallel`` with a group) makes the train
    step data-parallel (module docstring); the model and ``optimizer`` must
    start equal on every rank (``parallel.mesh.replicate``), and the seed
    source folds the rank into its draws.
    """
    return _steps(model, optimizer, n_classes, loss_weights, deterministic, graphed=False,
                  dp=active(dp))


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


def _steps(model, optimizer, n_classes, loss_weights, deterministic, graphed, dp=None):
    for group in optimizer.param_groups:
        if "initial_lr" not in group:
            group["initial_lr"] = float(group["lr"])
    # a model none of whose modules launches a kernel with dropout (the MELD
    # model: every dropout is torch's own) needs no seed source
    draws = any(hasattr(m, "dropout_seeds") for m in model.modules())
    seeds = None if deterministic or not draws else dropout_seeds_of([model])
    if dp is not None and seeds is not None:
        seeds.rank = dp.rank
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
            local = batch if dp is None else shard_batch(batch, dp.rank, dp.world)
            device = batch["label"].device
            with profiling.region(profiling.FORWARD, device):
                log_prob = forward(local)[0]
                whole = None if dp is None else nll_denominator(
                    batch["label"], batch["umask"], loss_weights, log_prob.dtype)
                loss, preds = loss_and_preds(log_prob, local, n_classes, loss_weights, whole)
            with profiling.region(profiling.BACKWARD, device):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            if dp is not None:
                all_reduce_grads(model.parameters(), dp)
                loss, preds = all_reduce_sum(loss, dp), all_gather_cat(preds, dp)
            with profiling.region(profiling.OPTIMIZER, device):
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

    train_run = ShapeGraphs(train_body, "train") if graphed else in_step_region(train_body)
    eval_run = ShapeGraphs(eval_body, "eval") if graphed else in_step_region(eval_body)

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


def make_grad_fn(
    model: torch.nn.Module,
    n_classes: int,
    loss_weights: Optional[torch.Tensor] = None,
    deterministic: bool = False,
    seed: int = 0,
) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
    """``grad_fn(batch) -> {name: gradient}`` (counterpart of
    ``gan_ffn_tpu/train/classifier.py::make_grad_fn``): the gradient of one
    batch's masked NLL with respect to every parameter of ``model``, keyed
    by its ``named_parameters()`` name, in training mode (every dropout on
    unless ``deterministic``), without an update and without touching
    ``.grad``.  It backs ``--tensorboard``'s per-epoch gradient histograms
    (the reference logs every parameter's ``.grad`` every batch,
    train_IEMOCAP.py:166-168).  Its kernel dropout seeds come from a
    generator of its own, seeded with ``seed``, and torch's RNG is restored
    after it, so the training draws what it would draw without it."""
    draws = any(hasattr(m, "dropout_seeds") for m in model.modules())
    seeds = None if deterministic or not draws else dropout_seeds_of([model])
    generator = torch.Generator().manual_seed(seed)
    names, params = zip(*model.named_parameters())

    def grad_fn(batch: Mapping) -> Dict[str, torch.Tensor]:
        device = batch["label"].device
        training = model.training
        model.train(not deterministic)
        base = (None if seeds is None else
                host_to_device(torch.tensor(draw_seed(generator), dtype=torch.int64), device))
        try:
            with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []), \
                    seeds.step(base) if seeds is not None else contextlib.nullcontext():
                out = model(*(batch[k] for k in model.INPUTS), valid_len=batch["valid_len"])
                log_prob = out[0] if model.ATTENTIONS else out
                loss, _ = loss_and_preds(log_prob, batch, n_classes, loss_weights)
                grads = torch.autograd.grad(loss, params, allow_unused=True,
                                            materialize_grads=True)
        finally:
            model.train(training)
        return dict(zip(names, grads))

    return grad_fn
