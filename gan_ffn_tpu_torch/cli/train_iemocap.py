"""IEMOCAP GAN-FFN trainer on PyTorch (counterpart of
``gan_ffn_tpu/cli/train_iemocap.py``; reference train_IEMOCAP.py:441-760).

Pipeline, as the reference's:

1. Stage A: ``--GAN-epochs`` epochs of the 12-duel adversarial pre-training
   of the three generators against the three discriminators
   (``cli/common.train_gan``), on loaders of its own (batch 32, valid 0.1).
   The loss history goes to ``{output_dir}/GAN_loss.csv`` and
   ``GAN_loss.png``, the six networks and their Adams to
   ``{model_save_path}/{name}.pt`` and ``opt/{name}.pt``.  With
   ``--use-trained-GAN`` the six are loaded instead (fresh Adams, as the
   reference resumes) and trained ``--continue-train-GAN-step`` more epochs,
   numbered on from the CSV's last, then saved again.
2. The three trained generators are grafted into ``GAN_FFN``.
3. Stage B: the classifier is trained with the masked NLL and torch's Adam
   (coupled L2), per epoch on train, then evaluated on valid and test; the
   epoch with the lowest test loss is kept.  The report goes to
   ``{output_dir}/test_out_GAN-epochs={g}_F1-score={f1}.txt`` and the best
   classifier's ``state_dict`` to ``{model_save_path}/classifier_best.pt``.

The msgpack checkpoints of the JAX package are not read or written here
(ROADMAP module note 8).  The flags of the JAX trainer are accepted by name;
those that need a later slice are refused with the ROADMAP item that brings
them.  ``--gan-schedule`` is accepted, and both values run the same step
(``stepwise`` is refused with ``--epoch-fused``, as the JAX trainer refuses
it).  ``--epoch-fused`` runs both stages' epochs fused: batches grouped by
shape, one CUDA graph per shape on a card (eager on the CPU), as
``cli/common.train_gan`` and ``train/loop.run_epoch_fused`` say.  ``--device`` (default ``cuda``) picks the device; ``--no-cuda`` is the
reference's way to ask for the CPU.

Seeds: ``--seed`` draws the weights of both stages (CPU ``torch.Generator``s)
and seeds torch's RNG for stage B's dropouts outside the kernels (positional
encoding, residuals); ``--seed + 1`` seeds torch's RNG for stage A's and the
generator that hands stage A's kernel calls their dropout seeds;
``--seed + 2`` seeds that generator for stage B.

Run: ``python -m gan_ffn_tpu_torch.cli.train_iemocap --synthetic --GAN-epochs 2 --epochs 2``
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from ..data import get_iemocap_loaders
from ..evaluation.metrics import f1_score
from ..evaluation.reports import format_test_report, write_test_report
from ..models import GAN_FFN
from ..nn.core import set_dropout_generator
from ..train.classifier import make_classifier_epoch_steps, make_classifier_steps
from ..train.loop import run_epoch, run_epoch_fused
from ..train.optim import torch_adam
from .common import (IEMOCAP_LOSS_WEIGHTS, IEMOCAP_N_CLASSES, graft_generators, param_count,
                     setup, stage_a)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="IEMOCAP GAN-FFN trainer (PyTorch)")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="train on the CPU (the same as --device cpu)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lr", type=float, default=0.0001, metavar="LR", help="learning rate")
    p.add_argument("--l2", type=float, default=0.008, metavar="L2", help="L2 regularization weight")
    p.add_argument("--dropout", type=float, default=0.6, metavar="dropout",
                   help="classifier dropout rate (unused in the forward, as in the reference)")
    p.add_argument("--batch-size", type=int, default=32, metavar="BS", help="batch size")
    p.add_argument("--epochs", type=int, default=160, metavar="E", help="number of epochs")
    p.add_argument("--GAN-epochs", type=int, default=150, metavar="E",
                   help="number of GAN epochs")
    p.add_argument("--class-weight", action="store_true", default=True, help="use class weight")
    p.add_argument("--attention", action="store_true", default=False,
                   help="compat; unused by GAN_FFN")
    p.add_argument("--tensorboard", action="store_true", default=False, help="refused for now")
    p.add_argument("--tb-grad-histograms", choices=("epoch", "batch"), default="epoch",
                   help="compat; needs --tensorboard")
    p.add_argument("--use-trained-GAN", action="store_true", default=False,
                   help="load the six GAN networks from --model-save-path")
    p.add_argument("--continue-train-GAN-step", type=int, default=5, metavar="E",
                   help="GAN epochs to continue training the loaded networks for")
    p.add_argument("--data-path", default="data/iemocap/IEMOCAP_features.pkl")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="generate a synthetic feature pickle if data-path is missing")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--model-save-path", default="./GAN_save/")
    p.add_argument("--num-layers", type=int, default=8, help="transformer encoder depth")
    p.add_argument("--scan-layers", action="store_true", default=False, help="refused for now")
    p.add_argument("--gan-schedule", choices=("fused", "stepwise"), default="fused",
                   help="compat: both run stage A's one eager loop")
    p.add_argument("--epoch-fused", action="store_true", default=False,
                   help="run both stages' epochs fused: batches grouped by shape, one CUDA "
                        "graph per shape replayed for its batches (eager on the CPU); each "
                        "batch keeps the per-batch loop's dropout draws, and where an epoch "
                        "spans several shapes, updates reorder across the groups")
    p.add_argument("--dp", action="store_true", default=False, help="refused for now")
    p.add_argument("--lr-schedule", choices=("reference", "decay"), default="reference",
                   help="reference: constant lr (the reference's LambdaLR re-creation "
                        "quirk); decay: 0.98^epoch")
    p.add_argument("--bf16", action="store_true", default=False, help="refused for now")
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--strict-parity", action="store_true", default=False,
                   help="replicate the reference's NaN on constant-feature normalization")
    p.add_argument("--profile", default=None, metavar="LOGDIR", help="refused for now")
    p.add_argument("--synthetic-train", type=int, default=120,
                   help="synthetic fixture train dialogues")
    p.add_argument("--synthetic-test", type=int, default=31)
    return p


def main(argv=None) -> dict:
    parser = build_parser()
    args, device = setup(parser, argv)
    gan_state = stage_a(args, device, args.use_trained_GAN, args.continue_train_GAN_step)

    # ---- Stage B: GAN_FFN with the trained generators ----
    torch.manual_seed(args.seed)
    model = GAN_FFN(n_classes=IEMOCAP_N_CLASSES, dropout=args.dropout,
                    gen_num_layers=args.num_layers,
                    generator=torch.Generator().manual_seed(args.seed), device=device)
    graft_generators(model, gan_state)
    set_dropout_generator(model, torch.Generator().manual_seed(args.seed + 2))
    train_loader, valid_loader, test_loader = get_iemocap_loaders(
        args.data_path, batch_size=args.batch_size, valid=0.1, seed=args.seed,
        strict_parity=args.strict_parity,
    )
    print("Number of parameter: %.2fM" % (param_count(model) / 1e6))

    loss_weights = torch.from_numpy(IEMOCAP_LOSS_WEIGHTS).to(device) if args.class_weight else None
    optimizer = torch_adam(model.parameters(), args.lr, weight_decay=args.l2)
    make_steps = make_classifier_epoch_steps if args.epoch_fused else make_classifier_steps
    train_step, eval_step = make_steps(model, optimizer, IEMOCAP_N_CLASSES, loss_weights)
    run = run_epoch_fused if args.epoch_fused else run_epoch

    print("=" * 15, "data loaded", "=" * 15)
    best = None  # (loss, labels, preds, masks)
    best_state = None
    for e in range(args.epochs):
        start_time = time.time()
        lr_scale = float(0.98**e) if args.lr_schedule == "decay" else None
        train_res = run(train_loader, train_step, device, lr_scale=lr_scale)
        valid_res = run(valid_loader, eval_step, device)
        test_res = run(test_loader, eval_step, device)
        if best is None or best[0] > test_res.avg_loss:
            best = (test_res.avg_loss, test_res.labels, test_res.preds, test_res.masks)
            best_state = copy.deepcopy(model.state_dict())

        elapsed = round(time.time() - start_time, 2)
        n_utt = float(np.sum(train_res.masks))
        print(
            "epoch {} train_loss {} train_acc {} train_fscore {} valid_loss {} "
            "valid_acc {} val_fscore {} test_loss {} test_acc {} test_fscore {} "
            "time {} ({:.1f} utt/s)".format(
                e + 1,
                train_res.avg_loss, train_res.avg_accuracy, train_res.avg_fscore,
                valid_res.avg_loss, valid_res.avg_accuracy, valid_res.avg_fscore,
                test_res.avg_loss, test_res.avg_accuracy, test_res.avg_fscore,
                elapsed, n_utt / max(elapsed, 1e-9),
            )
        )

    if best is None:
        parser.error("--epochs must be at least 1")
    os.makedirs(args.model_save_path, exist_ok=True)
    ckpt = os.path.join(args.model_save_path, "classifier_best.pt")
    torch.save(best_state, ckpt)
    print(f"saved best classifier to {ckpt}")
    best_loss, best_label, best_pred, best_mask = best
    print("Test performance..")
    path = write_test_report(
        args.output_dir, args.GAN_epochs, best_loss, best_label, best_pred, best_mask
    )
    print(f"Successfully save test_out to {path}")
    print(format_test_report(best_loss, best_label, best_pred, best_mask))
    return {
        "best_loss": best_loss,
        "f1": round(
            f1_score(best_label, best_pred, sample_weight=best_mask, average="weighted")
            * 100, 2,
        ),
        "report_path": path,
        "checkpoint": ckpt,
    }


if __name__ == "__main__":
    main()
