"""IEMOCAP GAN-FFN + DialogueRNN trainer on PyTorch (counterpart of
``gan_ffn_tpu/cli/train_iemocap_dialoguernn.py``; reference
train_IEMOCAP_DialogueRNN.py:547-837).

Pipeline, as the reference's:

1. Stage A, as the flagship trainer runs it (``cli/common.stage_a``, batch
   32): with ``--use-trained-GAN`` (the default) the six networks are
   loaded from ``{model_save_path}/*.pt`` where ``acoustic_gen.pt`` exists,
   so the flagship trainer's checkpoints serve; otherwise, or with
   ``--fresh-GAN``, they are trained for ``--GAN-epochs`` epochs and saved
   with their loss history.
2. The three trained generators are grafted into ``GAN_FFN_DialogueRNN``
   (the fusion sum feeding the bidirectional DialogueRNN ``BiModel``).
3. Stage B: per epoch, train, then evaluate on valid and test; the epoch
   with the lowest test loss is kept, with its test attention weights
   (att2's ``alpha`` and the two directions' ``alpha_f``, ``alpha_b``, cut
   to each batch's real dialogues, with their ``vids``).  Its
   ``state_dict`` goes to ``{model_save_path}/dialoguernn_classifier_best.pt``;
   the metrics are printed (no report file, as the reference).

Reference defaults that differ from the flagship trainer: batch 30, 100
epochs, ``--l2 1e-5``, ``--rec-dropout 0.1``, ``--dropout 0.6``,
``--attention general`` (the context attention), ``--active-listener``
off.  ``--dp``, ``--bf16``, ``--scan-layers`` and ``--tensorboard`` are
refused with the ROADMAP item that brings them.  ``--epoch-fused`` runs
both stages' epochs fused, as the flagship trainer's does.
``--device`` (default ``cuda``) picks the device; ``--no-cuda`` asks for
the CPU.

Seeds, as the flagship trainer's: ``--seed`` draws the weights of both
stages (CPU ``torch.Generator``s) and seeds torch's RNG for stage B, which
feeds every dropout outside the kernels: the DialogueRNN cell's
(``--rec-dropout``), the emotions' (``--dropout`` + 0.15) and the hidden
layer's (``--dropout``), and the generators' positional-encoding and
residual dropouts; ``--seed + 1`` seeds torch's RNG for stage A and the
generator of stage A's kernel dropout seeds; ``--seed + 2`` seeds the
generator that hands stage B's kernel calls (the generators' attention
and MLP dropouts) their seeds.

Run: ``python -m gan_ffn_tpu_torch.cli.train_iemocap_dialoguernn --synthetic --GAN-epochs 2 --epochs 2``
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import torch

from ..data import get_iemocap_loaders
from ..evaluation.metrics import classification_report, confusion_matrix, f1_score
from ..models import GAN_FFN_DialogueRNN
from ..nn.core import set_dropout_generator
from ..train.classifier import make_classifier_epoch_steps, make_classifier_steps
from ..train.loop import run_epoch, run_epoch_fused
from ..train.optim import torch_adam
from .common import (IEMOCAP_LOSS_WEIGHTS, IEMOCAP_N_CLASSES, graft_generators, param_count,
                     setup, stage_a)

# DialogueRNN widths (train_IEMOCAP_DialogueRNN.py:635-641)
D_m, D_g, D_p, D_e, D_h, D_a = 100, 500, 500, 100, 100, 100


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="IEMOCAP GAN-FFN + DialogueRNN trainer (PyTorch)")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="train on the CPU (the same as --device cpu)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lr", type=float, default=0.0001, metavar="LR")
    p.add_argument("--l2", type=float, default=0.00001, metavar="L2")
    p.add_argument("--rec-dropout", type=float, default=0.1, metavar="rec_dropout")
    p.add_argument("--dropout", type=float, default=0.6, metavar="dropout")
    p.add_argument("--batch-size", type=int, default=30, metavar="BS")
    p.add_argument("--epochs", type=int, default=100, metavar="E")
    p.add_argument("--attention", default="general",
                   choices=("simple", "dot", "general", "general2", "concat"),
                   help="context attention type")
    p.add_argument("--GAN-epochs", type=int, default=150, metavar="E")
    p.add_argument("--class-weight", action="store_true", default=True)
    p.add_argument("--active-listener", action="store_true", default=False)
    p.add_argument("--tensorboard", action="store_true", default=False, help="refused for now")
    p.add_argument("--use-trained-GAN", action="store_true", default=True,
                   help="load the six GAN networks from --model-save-path where they exist")
    p.add_argument("--fresh-GAN", dest="use_trained_GAN", action="store_false",
                   help="train the GAN from scratch instead of loading")
    p.add_argument("--data-path", default="data/iemocap/IEMOCAP_features.pkl")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="generate a synthetic feature pickle if data-path is missing")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--model-save-path", default="./GAN_save/")
    p.add_argument("--num-layers", type=int, default=8, help="transformer encoder depth")
    p.add_argument("--scan-layers", action="store_true", default=False, help="refused for now")
    p.add_argument("--epoch-fused", action="store_true", default=False,
                   help="run both stages' epochs fused: batches grouped by shape, one CUDA "
                        "graph per shape replayed for its batches (eager on the CPU); each "
                        "batch keeps the per-batch loop's dropout draws, and where an epoch "
                        "spans several shapes, updates reorder across the groups")
    p.add_argument("--lr-schedule", choices=("reference", "decay"), default="reference",
                   help="reference: constant lr (the reference's LambdaLR re-creation "
                        "quirk); decay: 0.98^epoch")
    p.add_argument("--dp", action="store_true", default=False, help="refused for now")
    p.add_argument("--bf16", action="store_true", default=False, help="refused for now")
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--strict-parity", action="store_true", default=False,
                   help="replicate the reference's NaN on constant-feature normalization")
    p.add_argument("--synthetic-train", type=int, default=120)
    p.add_argument("--synthetic-test", type=int, default=31)
    return p


def main(argv=None) -> dict:
    parser = build_parser()
    args, device = setup(parser, argv)
    load = args.use_trained_GAN and os.path.exists(
        os.path.join(args.model_save_path, "acoustic_gen.pt"))
    gan_state = stage_a(args, device, load, continue_epochs=0)

    # ---- Stage B: GAN_FFN_DialogueRNN with the trained generators ----
    torch.manual_seed(args.seed)
    model = GAN_FFN_DialogueRNN(
        D_m=D_m, D_g=D_g, D_p=D_p, D_e=D_e, D_h=D_h, D_a=D_a, n_classes=IEMOCAP_N_CLASSES,
        listener_state=args.active_listener, context_attention=args.attention,
        dropout_rec=args.rec_dropout, dropout=args.dropout, gen_num_layers=args.num_layers,
        generator=torch.Generator().manual_seed(args.seed), device=device)
    graft_generators(model, gan_state)
    del gan_state
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

    best = None  # (loss, labels, preds, masks, attentions)
    best_state = None
    for e in range(args.epochs):
        start_time = time.time()
        lr_scale = float(0.98**e) if args.lr_schedule == "decay" else None
        train_res = run(train_loader, train_step, device, lr_scale=lr_scale)
        valid_res = run(valid_loader, eval_step, device)
        test_res = run(test_loader, eval_step, device)
        if best is None or best[0] > test_res.avg_loss:
            best = (test_res.avg_loss, test_res.labels, test_res.preds, test_res.masks,
                    test_res.attentions)
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

    if best is None:
        parser.error("--epochs must be at least 1")
    os.makedirs(args.model_save_path, exist_ok=True)
    ckpt = os.path.join(args.model_save_path, "dialoguernn_classifier_best.pt")
    torch.save(best_state, ckpt)
    print(f"saved best classifier to {ckpt}")
    best_loss, best_label, best_pred, best_mask, best_attn = best
    final_f1 = round(
        f1_score(best_label, best_pred, sample_weight=best_mask, average="weighted") * 100, 2
    )
    print("Test performance..")
    print("Loss {} F1-score {}".format(best_loss, final_f1))
    print(classification_report(best_label, best_pred, sample_weight=best_mask, digits=4))
    print(confusion_matrix(best_label, best_pred, sample_weight=best_mask))
    return {"best_loss": best_loss, "f1": final_f1, "attentions": best_attn}


if __name__ == "__main__":
    main()
