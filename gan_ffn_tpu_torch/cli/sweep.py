"""GAN-epoch sweep on PyTorch (counterpart of ``gan_ffn_tpu/cli/sweep.py``;
reference run.sh:7-21 and its output/history artifacts).

The reference sweeps ``--GAN-epochs`` by re-running the whole entry script
once per value.  As the JAX package does, this runs ONE stage A and
snapshots the three generators at every point of ``--gan-epochs START STOP
STEP`` (inclusive), then trains one classifier per snapshot:

1. Stage A, as the trainers run it (batch 32, valid 0.1, torch's RNG seeded
   with ``--seed + 1``), its step built once (``cli/common.make_stage_a_step``)
   so that the segments between points continue one seed stream: snapshot
   ``g`` is the generators of an uninterrupted ``g``-epoch stage A.  Each
   snapshot is a clone, since the live parameters keep training (and a CUDA
   graph updates them in place).  The loss history goes to
   ``{output_dir}/GAN_loss.{csv,png}``.
2. Per point, from one base init (``--seed``) with the snapshot grafted:
   ``--epochs`` epochs of the classifier on train, each evaluated on test;
   the epoch with the lowest test loss is kept and its report written to
   ``{output_dir}/history/test_out_GAN-epochs={g}_F1-score={f1}.txt``.
   The point's model, Adam and CUDA graphs are freed before the next, so
   that device memory stays flat over the points.

``--epoch-fused`` (default AUTO, ``cli/common.resolve_epoch_fused_auto``:
fused where every dialogue falls in one bucket) fuses both stages' epochs,
one CUDA graph per batch shape on a card.  ``--bf16``, ``--device`` and
``--no-cuda`` as the trainers take them.  Returns ``{g: F1}`` and prints
the best point.

Run: ``python -m gan_ffn_tpu_torch.cli.sweep --gan-epochs 85 185 5 --epochs 160``
"""

from __future__ import annotations

import argparse
import gc
import os
import time

import torch

from ..data import get_iemocap_loaders, write_synthetic_iemocap
from ..evaluation.metrics import f1_score
from ..evaluation.reports import write_test_report
from ..models import GAN_FFN
from ..nn.core import set_dropout_generator
from ..train.classifier import make_classifier_epoch_steps, make_classifier_steps
from ..train.gan import GANConfig, init_gan_state
from ..train.loop import run_epoch, run_epoch_fused
from ..train.optim import torch_adam
from ..utils.artifacts import draw_gan_loss, save_gan_loss_csv
from .common import (IEMOCAP_LOSS_WEIGHTS, IEMOCAP_N_CLASSES, compute_dtype, generator_weights,
                     graft_generators, make_stage_a_step, resolve_epoch_fused_auto, setup,
                     train_gan)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GAN-epochs sweep (PyTorch)")
    p.add_argument("--gan-epochs", nargs=3, type=int, default=[85, 185, 5],
                   metavar=("START", "STOP", "STEP"),
                   help="sweep range over GAN pre-train epochs (inclusive stop)")
    p.add_argument("--epochs", type=int, default=160, help="classifier epochs per point")
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--l2", type=float, default=0.008)
    p.add_argument("--dropout", type=float, default=0.6)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--data-path", default="data/iemocap/IEMOCAP_features.pkl")
    p.add_argument("--synthetic", action="store_true", default=False)
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--epoch-fused", action=argparse.BooleanOptionalAction, default=None,
                   help="both stages' epochs fused, one CUDA graph per batch shape; default "
                        "AUTO: fused where every dialogue falls in one bucket (then it is the "
                        "per-batch loop), per batch where they span several")
    p.add_argument("--bf16", action="store_true", default=False)
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="run on the CPU (the same as --device cpu)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--synthetic-train", type=int, default=120)
    p.add_argument("--synthetic-test", type=int, default=31)
    p.add_argument("--synthetic-max-len", type=int, default=110)
    p.add_argument("--synthetic-class-spread", type=float, default=2.0)
    p.add_argument("--synthetic-noise", type=float, default=1.0)
    p.add_argument("--synthetic-label-noise", type=float, default=0.0)
    p.add_argument("--synthetic-confusable-pairs", type=int, default=0,
                   help="collapse N class-mean pairs per modality (rotated), so that classes "
                        "separate only through cross-modal fusion")
    p.add_argument("--synthetic-nonuniform-priors", action="store_true", default=False,
                   help="skew class priors (geometric 0.75 decay)")
    return p


def stage_a_snapshots(cfg: GANConfig, loader, points, device, epoch_fused: bool,
                      log=print):
    """One stage A over ``loader`` up to ``points[-1]`` epochs, the
    generators snapshotted (:func:`cli.common.generator_weights`) at each of
    ``points``: ``({g: weights}, loss history)``."""
    state = init_gan_state(cfg, device)
    step = make_stage_a_step(cfg, state, epoch_fused)
    snapshots, history, prev = {}, [], 0
    for g in points:
        state, history = train_gan(cfg, loader, g - prev, state=state, history=history,
                                   start_epoch=prev, device=device, log=log,
                                   log_every_batch=False, epoch_fused=epoch_fused, step=step)
        prev = g
        snapshots[g] = generator_weights(state)
        log(f"snapshotted generators at GAN epoch {g}")
    return snapshots, history


def main(argv=None) -> dict:
    parser = build_parser()
    args, device = setup(parser, argv, write_fixture=None)
    if args.synthetic and os.path.exists(args.data_path):
        print(f"WARNING: {args.data_path} already exists; --synthetic-* fixture parameters "
              "are IGNORED (delete the file or point --data-path elsewhere to regenerate)")
    elif args.synthetic:
        write_synthetic_iemocap(
            args.data_path, n_train=args.synthetic_train, n_test=args.synthetic_test,
            max_len=args.synthetic_max_len, seed=args.seed,
            class_spread=args.synthetic_class_spread, noise=args.synthetic_noise,
            label_noise=args.synthetic_label_noise,
            confusable_pairs=args.synthetic_confusable_pairs,
            class_priors=([0.75**i for i in range(6)] if args.synthetic_nonuniform_priors
                          else None),
        )
    start, stop, stride = args.gan_epochs
    points = list(range(start, stop + 1, stride))
    if not points or points[0] < 0:
        parser.error(f"--gan-epochs {start} {stop} {stride} gives no sweep point")
    dtype = compute_dtype(args)
    gan_cfg = GANConfig(num_layers=args.num_layers, dtype=dtype, seed=args.seed)
    gan_loader, _, _ = get_iemocap_loaders(args.data_path, batch_size=32, valid=0.1,
                                           seed=args.seed)
    if args.epoch_fused is None:
        args.epoch_fused = resolve_epoch_fused_auto(gan_loader)

    torch.manual_seed(args.seed + 1)
    t0 = time.time()
    snapshots, history = stage_a_snapshots(gan_cfg, gan_loader, points, device,
                                           args.epoch_fused)
    print(f"stage A: {points[-1]} GAN epochs in {time.time() - t0:.2f}s")
    save_gan_loss_csv(history, os.path.join(args.output_dir, "GAN_loss.csv"))
    draw_gan_loss(history, os.path.join(args.output_dir, "GAN_loss.png"))

    train_loader, _, test_loader = get_iemocap_loaders(
        args.data_path, batch_size=args.batch_size, valid=0.1, seed=args.seed)
    weights = torch.from_numpy(IEMOCAP_LOSS_WEIGHTS).to(device)
    make_steps = make_classifier_epoch_steps if args.epoch_fused else make_classifier_steps
    run = run_epoch_fused if args.epoch_fused else run_epoch
    history_dir = os.path.join(args.output_dir, "history")
    results = {}
    for g in points:
        t0 = time.time()
        torch.manual_seed(args.seed)
        model = GAN_FFN(n_classes=IEMOCAP_N_CLASSES, dropout=args.dropout,
                        gen_num_layers=args.num_layers,
                        generator=torch.Generator().manual_seed(args.seed), device=device,
                        dtype=dtype)
        graft_generators(model, snapshots[g])
        set_dropout_generator(model, torch.Generator().manual_seed(args.seed + 2))
        optimizer = torch_adam(model.parameters(), args.lr, weight_decay=args.l2)
        train_step, eval_step = make_steps(model, optimizer, IEMOCAP_N_CLASSES, weights)
        best = None  # (loss, labels, preds, masks)
        for _ in range(args.epochs):
            run(train_loader, train_step, device)
            test_res = run(test_loader, eval_step, device)
            if best is None or best[0] > test_res.avg_loss:
                best = (test_res.avg_loss, test_res.labels, test_res.preds, test_res.masks)
        # the point's model, Adam and graph pools go before the next point's;
        # so do the cuBLAS workspaces of its dispatchers' streams, which
        # torch keeps per stream for the life of the process
        del model, optimizer, train_step, eval_step
        gc.collect()
        if device.type == "cuda":
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
            print(f"GAN-epochs={g}: device memory {torch.cuda.memory_allocated(device)} B "
                  f"allocated, {torch.cuda.memory_reserved(device)} B reserved after the point")
        if best is None:
            parser.error("--epochs must be at least 1")
        path = write_test_report(history_dir, g, *best)
        f1 = round(f1_score(best[1], best[2], sample_weight=best[3], average="weighted") * 100, 2)
        results[g] = f1
        print(f"GAN-epochs={g}: F1={f1} ({time.time() - t0:.2f}s) -> {path}")

    best_g = max(results, key=results.get)
    print(f"best: GAN-epochs={best_g} F1={results[best_g]}")
    return results


if __name__ == "__main__":
    main()
