"""MELD trainer on PyTorch (counterpart of ``gan_ffn_tpu/cli/train_meld.py``;
reference train_MELD.py:107-197).

``MELDLSTMModel`` on the text features alone; the reference runs no GAN on
MELD.  Widths D_m 600, D_e 300, D_h 600 (train_MELD.py:143-145); 7 classes
(``--classify emotion``) or 3 (``sentiment``); the unweighted masked NLL;
valid split 0.0, so the valid loader is empty and its metrics print as
``nan``.  Per epoch: train, then evaluate on valid and test; the epoch with
the **highest test F1** is kept (train_MELD.py:175-177, unlike the IEMOCAP
trainers' lowest test loss), with its test attention weights (``alpha``,
cut to each batch's real dialogues, with their ``vids``).  Its
``state_dict`` goes to ``{model_save_path}/meld_classifier_best.pt``, and
its report and confusion matrix are printed.

``--epoch-fused`` runs the epochs as the IEMOCAP trainers' do: batches
grouped by shape, one CUDA graph per shape replayed for its batches (eager
on the CPU).  ``--bf16`` computes in bfloat16 from float32 parameters cast
at each use (the LSTM at bf16, the attention's epilogue and the
log-softmax in float32); the checkpoint stays float32.  ``--tensorboard``
is refused with the ROADMAP item that brings it; ``--tb-grad-histograms``
and ``--attention`` are accepted as the JAX trainer's are.  ``--device``
(default ``cuda``) picks the device; ``--no-cuda`` asks for the CPU.

Seeds: ``--seed`` draws the weights (a CPU ``torch.Generator``), seeds
torch's RNG, which feeds every dropout (the LSTM's between layers; the
model launches no kernel), and seeds the loaders' shuffles.

Run: ``python -m gan_ffn_tpu_torch.cli.train_meld --synthetic --epochs 2``
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import torch

from ..data import get_meld_loaders, write_synthetic_meld
from ..evaluation.metrics import classification_report, confusion_matrix, f1_score
from ..models import MELDLSTMModel
from ..train.classifier import make_classifier_epoch_steps, make_classifier_steps
from ..train.loop import run_epoch, run_epoch_fused
from ..train.optim import torch_adam
from .common import compute_dtype, param_count, setup

D_m, D_e, D_h = 600, 300, 600  # train_MELD.py:143-145


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MELD trainer (PyTorch)")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="train on the CPU (the same as --device cpu)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lr", type=float, default=0.0003, metavar="LR")
    p.add_argument("--l2", type=float, default=0.0001, metavar="L2")
    p.add_argument("--dropout", type=float, default=0.6, metavar="dropout")
    p.add_argument("--batch-size", type=int, default=32, metavar="BS")
    p.add_argument("--epochs", type=int, default=50, metavar="E")
    p.add_argument("--attention", action="store_true", default=True,
                   help="compat: the model always attends (att2)")
    p.add_argument("--tensorboard", action="store_true", default=False, help="refused for now")
    p.add_argument("--tb-grad-histograms", choices=("epoch", "batch"), default="epoch",
                   help="compat; needs --tensorboard")
    p.add_argument("--classify", default="emotion", choices=("emotion", "sentiment"))
    p.add_argument("--epoch-fused", action="store_true", default=False,
                   help="batches grouped by shape, one CUDA graph per shape replayed for its "
                        "batches (eager on the CPU); where an epoch spans several shapes, "
                        "updates reorder across the groups")
    p.add_argument("--data-path", default="data/meld/MELD_features_raw.pkl")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="generate a synthetic feature pickle if data-path is missing")
    p.add_argument("--synthetic-train", type=int, default=80,
                   help="synthetic fixture train dialogues")
    p.add_argument("--synthetic-test", type=int, default=20)
    p.add_argument("--model-save-path", default="./GAN_save/")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 compute from float32 parameters cast at each use; the "
                        "attention's epilogue, the log-softmax and Adam in float32")
    p.add_argument("--seed", type=int, default=3407)
    return p


def main(argv=None) -> dict:
    parser = build_parser()
    args, device = setup(parser, argv, write_fixture=write_synthetic_meld)
    n_classes = 7 if args.classify == "emotion" else 3

    torch.manual_seed(args.seed)
    model = MELDLSTMModel(D_m=D_m, D_e=D_e, D_h=D_h, n_classes=n_classes, dropout=args.dropout,
                          generator=torch.Generator().manual_seed(args.seed), device=device,
                          dtype=compute_dtype(args))
    train_loader, valid_loader, test_loader = get_meld_loaders(
        args.data_path, batch_size=args.batch_size, valid=0.0, classify=args.classify,
        seed=args.seed,
    )
    print("Number of parameter: %.2fM" % (param_count(model) / 1e6))

    optimizer = torch_adam(model.parameters(), args.lr, weight_decay=args.l2)
    make_steps = make_classifier_epoch_steps if args.epoch_fused else make_classifier_steps
    train_step, eval_step = make_steps(model, optimizer, n_classes)
    run = run_epoch_fused if args.epoch_fused else run_epoch

    best = None  # (fscore, loss, labels, preds, masks, attentions)
    best_state = None
    for e in range(args.epochs):
        start_time = time.time()
        train_res = run(train_loader, train_step, device)
        valid_res = run(valid_loader, eval_step, device)
        test_res = run(test_loader, eval_step, device)
        if best is None or best[0] < test_res.avg_fscore:
            best = (test_res.avg_fscore, test_res.avg_loss, test_res.labels, test_res.preds,
                    test_res.masks, test_res.attentions)
            best_state = copy.deepcopy(model.state_dict())
        elapsed = round(time.time() - start_time, 2)
        n_utt = float(train_res.masks.sum())
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
        print(classification_report(test_res.labels, test_res.preds,
                                    sample_weight=test_res.masks, digits=4))

    if best is None:
        parser.error("--epochs must be at least 1")
    os.makedirs(args.model_save_path, exist_ok=True)
    ckpt = os.path.join(args.model_save_path, "meld_classifier_best.pt")
    torch.save(best_state, ckpt)
    print(f"saved best classifier to {ckpt}")
    best_fscore, best_loss, best_label, best_pred, best_mask, best_attn = best
    print("Test performance..")
    print("Loss {} F1-score {}".format(
        best_loss,
        round(f1_score(best_label, best_pred, sample_weight=best_mask, average="weighted") * 100, 2),
    ))
    print(classification_report(best_label, best_pred, sample_weight=best_mask, digits=4))
    print(confusion_matrix(best_label, best_pred, sample_weight=best_mask))
    return {"best_loss": best_loss, "f1": best_fscore, "attentions": best_attn}


if __name__ == "__main__":
    main()
