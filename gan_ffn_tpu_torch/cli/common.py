"""Shared wiring of the training entry points (counterpart of
``gan_ffn_tpu/cli/common.py``): stage A's epoch loop and its run as both
IEMOCAP trainers drive it, the trainers' ``--dp`` and ``--tensorboard``,
the ``--epoch-fused`` AUTO policy, the class weights and the parameter
count.

The JAX package's epoch-fused branch (one program per same-shape batch
group) is here one CUDA graph per batch shape, replayed for every batch of
that shape (``train/graphs.py``); on the CPU the same grouped epoch runs
eagerly.
"""

from __future__ import annotations

import argparse
import copy
import os
import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data import get_iemocap_loaders, write_synthetic_iemocap
from ..data.loaders import Batch, BucketedLoader, _bucket_for
from ..nn.core import set_dropout_generator
from ..ops.dropout import StepSeeds
from ..parallel.mesh import DataParallel, fold_torch_seed, init_data_parallel, replicate
from ..train.classifier import GENERATOR_GAN_KEYS, graft_generator_params, make_grad_fn
from ..train.gan import (LOGGED_LOSS_KEYS, GANConfig, GANState, init_gan_state,
                         make_gan_epoch_step, make_gan_train_step)
from ..train.loop import batch_to_tensors, fused_order
from ..utils.artifacts import (LossHistory, append_loss_row, draw_gan_loss, load_gan_loss_csv,
                               save_gan_loss_csv)
from ..utils.checkpoint import load_gan_state, save_gan_state
from ..utils.runtime import configure_cuda_runtime, wait_for_device
from ..utils.tensorboard import TBWriter

# IEMOCAP 6-class weights (train_IEMOCAP.py:653)
IEMOCAP_LOSS_WEIGHTS = np.array(
    [1.2, 0.60072, 0.38066, 0.94019, 0.67924, 0.34332], dtype=np.float32
)
IEMOCAP_N_CLASSES = 6


def setup(parser: argparse.ArgumentParser, argv=None,
          write_fixture: Callable[..., str] = write_synthetic_iemocap,
          ) -> Tuple[argparse.Namespace, torch.device]:
    """A trainer's start: parse ``argv``, refuse the flag combinations the
    JAX trainers refuse, pick the device
    (``--device``, or the CPU with ``--no-cuda``; a parser error where it
    asks for a card that is not there), set the CUDA runtime's float32
    flags (``utils.runtime.configure_cuda_runtime``), wait for the card
    where one is asked for (``utils.runtime.wait_for_device``, which raises
    rather than fall back to the CPU), and write the synthetic fixture
    where ``--synthetic`` asks for it, with ``write_fixture`` (the IEMOCAP
    writer, or ``data.write_synthetic_meld``; None: the caller writes
    it)."""
    args = parser.parse_args(argv)
    if getattr(args, "epoch_fused", False) and getattr(args, "gan_schedule", None) == "stepwise":
        parser.error("--epoch-fused runs the fused 12-duel step; it cannot honour "
                     "--gan-schedule stepwise's fast-compile promise: drop one of the two flags")
    if getattr(args, "epoch_fused", False) and getattr(args, "dp", False):
        parser.error("--epoch-fused is not wired for --dp (the stacked epoch is not "
                     "mesh-sharded); use per-batch --dp, or --epoch-fused single-chip")
    if (getattr(args, "epoch_fused", False) and getattr(args, "tensorboard", False)
            and getattr(args, "tb_grad_histograms", None) == "batch"):
        parser.error("--epoch-fused cannot honour --tb-grad-histograms batch: the per-batch "
                     "grad hook is the dispatch pattern the fused epoch removes; use "
                     "--tb-grad-histograms epoch, or drop --epoch-fused")
    print(args)
    device = torch.device("cpu" if args.no_cuda else args.device)
    configure_cuda_runtime()
    if device.type == "cuda":
        if not torch.cuda.is_available():
            parser.error("no CUDA card: pass --device cpu to train on the CPU")
        wait_for_device(device)
    print(f"Running on {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    if write_fixture is not None and args.synthetic and not os.path.exists(args.data_path):
        write_fixture(
            args.data_path, n_train=args.synthetic_train, n_test=args.synthetic_test,
            seed=args.seed,
        )
        print(f"wrote synthetic features to {args.data_path}")
    return args, device


def compute_dtype(args) -> Optional[torch.dtype]:
    """The models' compute dtype a trainer's ``--bf16`` asks for (None:
    float32), as the JAX trainers derive it: float32 parameters, cast to
    bf16 at each use, with LayerNorm, the log-softmax and Adam in float32."""
    return torch.bfloat16 if args.bf16 else None


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def data_parallel(args, device: torch.device) -> Tuple[Optional[DataParallel], torch.device]:
    """A trainer's ``--dp`` (counterpart of the JAX trainers' stage-A mesh):
    ``(dp, device)``, where ``dp`` is this process's data-parallel group
    under ``python -m torch.distributed.run`` (``parallel.mesh.init_data_parallel``:
    NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU) and ``device`` the rank's
    device.  Without ``--dp``, or without a torchrun environment: ``(None,
    device)``.  A group of one process prints the JAX trainer's message and
    keeps its hooks, which are the single-process step bit for bit."""
    if not getattr(args, "dp", False):
        return None, device
    dp = init_data_parallel(device)
    if dp.world == 1:
        print("--dp requested but only one device present; running single-chip")
    if dp.group is None:
        return None, device
    print(f"stage A data parallelism over {dp.world} process(es): rank {dp.rank} on "
          f"{dp.device}, backend {dp.backend}")
    return dp, dp.device


class TensorBoardLog:
    """A trainer's ``--tensorboard`` (the JAX trainers' ``TBWriter`` use,
    ``gan_ffn_tpu/cli/train_iemocap.py:234-330``): ``./tensorboard`` event
    files with ``test: accuracy/loss`` and ``train: accuracy/loss`` per
    epoch and one histogram per named parameter, by
    ``--tb-grad-histograms``: ``epoch``, the gradients of one sampled batch
    (the train loader's first, drawn without advancing its epochs) through
    ``train.classifier.make_grad_fn`` after each epoch (its dropout seeds
    from ``args.seed + 3``); ``batch``, the gradients each train step
    applied, through ``train.loop.run_epoch``'s ``on_batch`` hook, tagged
    with the epoch.  Both are gated on ``writer.enabled``, as in JAX: a
    writer without the ``tensorboard`` package costs nothing."""

    def __init__(self, args, model: nn.Module, train_loader: BucketedLoader, device,
                 n_classes: int, loss_weights: Optional[torch.Tensor] = None):
        self.writer = TBWriter("./tensorboard", enabled=args.tensorboard)
        cadence = args.tb_grad_histograms if self.writer.enabled else None
        self.model, self.per_batch = model, cadence == "batch"
        self.grad_fn = self.sample = None
        if cadence == "epoch":
            self.grad_fn = make_grad_fn(model, n_classes, loss_weights, seed=args.seed + 3)
            self.sample = batch_to_tensors(next(iter(copy.copy(train_loader))), device)

    def run_kwargs(self, epoch: int) -> dict:
        """The train epoch's ``on_batch`` hook, where the cadence is ``batch``."""
        if not self.per_batch:
            return {}
        return {"on_batch": lambda i, batch, out: self.writer.add_param_histograms(
            self.model, epoch)}

    def end_epoch(self, epoch: int, train_res, test_res) -> None:
        if self.grad_fn is not None:
            self.writer.add_param_histograms(self.grad_fn(self.sample), epoch)
        self.writer.add_scalar("test: accuracy/loss", test_res.avg_accuracy / test_res.avg_loss,
                               epoch)
        self.writer.add_scalar("train: accuracy/loss",
                               train_res.avg_accuracy / train_res.avg_loss, epoch)

    def close(self) -> None:
        self.writer.close()


def generator_weights(gan_state: GANState) -> Dict[str, torch.Tensor]:
    """Stage A's three generators' weights under their stage-A names
    (``acoustic_gen.*``, ...), cloned: a snapshot that later training does
    not touch."""
    return {f"{name}.{k}": v.detach().clone() for name in GENERATOR_GAN_KEYS
            for k, v in gan_state.modules[name].state_dict().items()}


def graft_generators(model: nn.Module, gan_state) -> None:
    """Load stage A's three generators into ``model``'s (reference: the
    trained generator objects passed into the classifier,
    train_IEMOCAP.py:629-635), from a :class:`GANState` or a
    :func:`generator_weights` snapshot."""
    gan_weights = generator_weights(gan_state) if isinstance(gan_state, GANState) else gan_state
    model.load_state_dict(graft_generator_params(model.state_dict(), gan_weights))


def gan_batch_from(tensors: Mapping) -> Dict[str, object]:
    """The part of a ``train.loop.batch_to_tensors`` batch that stage A reads."""
    keys = ("text", "visual", "audio", "valid_len", "n_real", "seed")
    return {k: tensors[k] for k in keys if k in tensors}


def resolve_epoch_fused_auto(loader: BucketedLoader) -> bool:
    """AUTO policy for ``--epoch-fused`` (counterpart of
    ``gan_ffn_tpu/cli/common.py::resolve_epoch_fused_auto``): fuse exactly
    when every dialogue's length maps to one bucket, so that every batch of
    every epoch has one shape and the fused epoch is the per-batch loop.
    Where lengths span several buckets, grouping would reorder updates
    across shapes, so AUTO keeps the per-batch loop.  A dialogue longer
    than the largest bucket raises, as the loader does (the JAX policy
    clamps it into the largest bucket instead)."""
    buckets = {_bucket_for(loader.dataset[int(i)].length, loader.buckets)
               for i in loader.indices}
    fused = len(buckets) <= 1
    print(f"--epoch-fused AUTO: dialogue lengths span bucket(s) {sorted(buckets)} -> "
          + ("fused (one shape: the per-batch loop's results, one graph per shape)" if fused
             else "per-batch (several shapes would reorder updates across shape groups; "
                  "pass --epoch-fused to force fusion)"))
    return fused


def make_stage_a_step(cfg: GANConfig, state: GANState, epoch_fused: bool = False,
                      dp: Optional[DataParallel] = None) -> Callable:
    """Stage A's step over ``state``, as :func:`train_gan` builds it: one
    seed source over a CPU generator seeded with ``cfg.seed + 1``, set on
    all six networks, and :func:`train.gan.make_gan_train_step` or, with
    ``epoch_fused``, :func:`train.gan.make_gan_epoch_step`, either with
    ``dp``.  Build it once to train in segments (``train_gan(step=...)``):
    the segments then continue one seed stream."""
    seeds = StepSeeds(torch.Generator().manual_seed(cfg.seed + 1))
    for module in state.modules.values():
        set_dropout_generator(module, seeds)
    make = make_gan_epoch_step if epoch_fused else make_gan_train_step
    return make(state.modules, state.opts, dp=dp)


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
    epoch_fused: bool = False,
    step: Optional[Callable] = None,
    dp: Optional[DataParallel] = None,
) -> Tuple[GANState, LossHistory]:
    """Adversarial pre-training (reference train_GAN, train_IEMOCAP.py:255-393):
    ``epochs`` epochs of the 12-duel step over ``train_loader``, numbered from
    ``start_epoch``.

    ``state`` defaults to :func:`train.gan.init_gan_state` on ``device``.
    The kernels' dropout seeds come from a CPU generator seeded with
    ``cfg.seed + 1``, set on all six networks.  The losses stay on the
    device until the epoch ends and come back in one copy; one row per epoch,
    the last batch's losses in loader order, is appended to ``history`` (the
    reference's CSV cadence).  ``step`` (built once for training in
    segments) defaults to :func:`train.gan.make_gan_train_step`, or with
    ``epoch_fused`` to :func:`train.gan.make_gan_epoch_step`.

    ``epoch_fused`` (``--epoch-fused``) runs each epoch as the JAX package
    does: batches grouped by shape, groups in order of first appearance,
    each in loader order; every batch gets the seed base the per-batch loop
    would have drawn for it (all drawn first, in loader order); the loss
    rows are logged in loader order.  On a card each shape is one CUDA
    graph, captured at its first batch and replayed for the others.  A
    single-shape epoch is the per-batch loop; where an epoch spans several
    shapes, updates reorder across the groups.  With ``dp`` either step is
    data-parallel (the JAX package's sharded epoch, ``make_gan_epoch_step(cfg,
    mesh=mesh)``): each rank trains on its slice of every batch and the
    gradients are summed before each update.  Both trainers still refuse
    ``--dp --epoch-fused``, as the JAX trainers do."""
    if state is None:
        state = init_gan_state(cfg, device)
    if history is None:
        history = []
    if step is None:
        step = make_stage_a_step(cfg, state, epoch_fused, dp)
    if dp is not None:
        replicate(state.modules.values(), state.opts.values(), dp)
        fold_torch_seed(dp)

    log("=" * 15 + " start training GAN " + "=" * 15)
    for epoch in range(start_epoch, start_epoch + epochs):
        t0 = time.time()
        batches = list(train_loader)
        if not batches:
            continue
        rows: list = [None] * len(batches)
        if epoch_fused:
            order, bases = fused_order(batches, step.seeds)
        else:
            order, bases = range(len(batches)), [None] * len(batches)
        for i in order:
            losses = step(gan_batch_from(batch_to_tensors(batches[i], device, seed=bases[i])))
            rows[i] = torch.stack([losses[k] for k in LOGGED_LOSS_KEYS])
        fetched = torch.stack(rows).cpu().tolist()  # one copy for the epoch
        dt = time.time() - t0
        utterances = sum(b.n_utterances for b in batches)
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


def stage_a(args, device, load: bool, continue_epochs: int,
            dp: Optional[DataParallel] = None) -> GANState:
    """Stage A as the reference's trainers run it, on loaders of its own
    (batch 32, valid 0.1): train the six GAN networks for
    ``args.GAN_epochs`` epochs, or, with ``load``, load them from
    ``args.model_save_path`` (fresh Adams, as the reference resumes) and
    train them ``continue_epochs`` more, numbered on from the loss CSV's
    last.  Whatever was trained is saved (``utils/checkpoint.py``, in the
    stacked layout with ``args.scan_layers``) with its loss history
    (``{output_dir}/GAN_loss.{csv,png}``); loaded networks that train no
    more are returned as they are.  ``args.epoch_fused`` runs the epochs
    fused (:func:`train_gan`), and ``args.bf16`` at bf16
    (:func:`compute_dtype`); the checkpoints hold the float32 parameters
    either way.  torch's RNG is seeded with ``args.seed + 1`` for stage A's
    dropouts outside the kernels.  ``dp`` trains data-parallel
    (:func:`train_gan`); rank 0 alone writes the files.  Where ``args`` has
    no ``output_dir`` (the seed sweep), no loss history is written."""
    gan_cfg = GANConfig(num_layers=args.num_layers, dtype=compute_dtype(args),
                        seed=args.seed)  # lr 1e-4, betas (0.5, 0.6)
    gan_train_loader, _, _ = get_iemocap_loaders(
        args.data_path, batch_size=32, valid=0.1, seed=args.seed,
        strict_parity=getattr(args, "strict_parity", False),
    )
    output_dir = getattr(args, "output_dir", None)
    loss_csv = os.path.join(output_dir or ".", "GAN_loss.csv")
    epoch_fused = getattr(args, "epoch_fused", False)
    torch.manual_seed(args.seed + 1)
    if load:
        gan_state = load_gan_state(args.model_save_path, *init_gan_state(gan_cfg, device),
                                   reset_opt=True)
        print("=" * 15, args.model_save_path + " loaded trained GAN", "=" * 15)
        if continue_epochs <= 0:
            return gan_state
        history = (load_gan_loss_csv(loss_csv) if output_dir and os.path.exists(loss_csv)
                   else [])
        print("=" * 15, "continue train GAN", "=" * 15)
        gan_state, history = train_gan(
            gan_cfg, gan_train_loader, continue_epochs, state=gan_state,
            history=history, start_epoch=(history[-1]["epoch"] + 1) if history else 0,
            device=device, epoch_fused=epoch_fused, dp=dp,
        )
    else:
        gan_state, history = train_gan(gan_cfg, gan_train_loader, args.GAN_epochs, device=device,
                                       epoch_fused=epoch_fused, dp=dp)
    if dp is None or dp.rank == 0:
        if output_dir:
            save_gan_loss_csv(history, loss_csv)
            draw_gan_loss(history, os.path.join(output_dir, "GAN_loss.png"))
        save_gan_state(args.model_save_path, gan_state,
                       scan_layers=getattr(args, "scan_layers", False))
    print("=" * 15, "finished training GAN", "=" * 15)
    return gan_state
