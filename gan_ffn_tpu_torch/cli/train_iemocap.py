"""IEMOCAP GAN-FFN trainer on PyTorch (counterpart of
``gan_ffn_tpu/cli/train_iemocap.py``; reference train_IEMOCAP.py:441-760),
stage B only.

The flagship ``GAN_FFN`` classifier is trained with the masked NLL and
torch's Adam (coupled L2), per epoch on train, then evaluated on valid and
test; the epoch with the lowest test loss is kept.  At the end the report
goes to ``{output_dir}/test_out_GAN-epochs={g}_F1-score={f1}.txt`` and the
best classifier's ``state_dict`` to ``{model_save_path}/classifier_best.pt``
(``torch.save``).  The msgpack checkpoints of the JAX package are not read
or written here; that bridge is ROADMAP module note 8.

Stage A, the adversarial pre-training of the generators, is not ported yet
(ROADMAP Queue 1, item 1): ``--GAN-epochs`` must be 0, and the generators
start from the classifier's own init.  The flags of the JAX trainer are
accepted by name; those that need stage A or a later slice are refused with
the ROADMAP item that brings them.  ``--device`` (default ``cuda``) picks
the device; ``--no-cuda`` is the reference's way to ask for the CPU.

Seeds: ``--seed`` draws the weights (a CPU ``torch.Generator``), seeds
torch's RNG for the dropouts outside the kernels (positional encoding,
residuals), and seeds the generator that hands each kernel call its dropout
seed.

Run: ``python -m gan_ffn_tpu_torch.cli.train_iemocap --synthetic --GAN-epochs 0 --epochs 2``
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from ..data import get_iemocap_loaders, write_synthetic_iemocap
from ..evaluation.metrics import f1_score
from ..evaluation.reports import format_test_report, write_test_report
from ..models import GAN_FFN
from ..nn.core import set_dropout_generator
from ..train.classifier import make_classifier_steps
from ..train.loop import run_epoch
from ..train.optim import torch_adam

# IEMOCAP class weights (train_IEMOCAP.py:653)
IEMOCAP_LOSS_WEIGHTS = np.array(
    [1.2, 0.60072, 0.38066, 0.94019, 0.67924, 0.34332], dtype=np.float32
)
N_CLASSES = 6

# flag -> the ROADMAP item that brings it
_LATER = {
    "use_trained_GAN": "Queue 1 item 1 (stage A) and module note 8 (checkpoints)",
    "epoch_fused": "module note 12 (epoch-fused stages)",
    "dp": "module note 13 (parallel and sweeps)",
    "scan_layers": "module note 15 (the scanned layer layout)",
    "bf16": "Queue 1 item 5 (bf16 kernels)",
    "tensorboard": "module note 15 (utilities)",
    "profile": "module note 15 (utilities)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="IEMOCAP GAN-FFN trainer (PyTorch, stage B)")
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
                   help="number of GAN epochs: must be 0 until stage A is ported")
    p.add_argument("--class-weight", action="store_true", default=True, help="use class weight")
    p.add_argument("--attention", action="store_true", default=False,
                   help="compat; unused by GAN_FFN")
    p.add_argument("--tensorboard", action="store_true", default=False, help="refused for now")
    p.add_argument("--tb-grad-histograms", choices=("epoch", "batch"), default="epoch",
                   help="compat; needs --tensorboard")
    p.add_argument("--use-trained-GAN", action="store_true", default=False, help="refused for now")
    p.add_argument("--continue-train-GAN-step", type=int, default=5, metavar="E",
                   help="compat; needs --use-trained-GAN")
    p.add_argument("--data-path", default="data/iemocap/IEMOCAP_features.pkl")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="generate a synthetic feature pickle if data-path is missing")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--model-save-path", default="./GAN_save/")
    p.add_argument("--num-layers", type=int, default=8, help="transformer encoder depth")
    p.add_argument("--scan-layers", action="store_true", default=False, help="refused for now")
    p.add_argument("--gan-schedule", choices=("fused", "stepwise"), default="fused",
                   help="compat; stage A only")
    p.add_argument("--epoch-fused", action="store_true", default=False, help="refused for now")
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
    args = parser.parse_args(argv)
    if args.GAN_epochs != 0:
        parser.error("--GAN-epochs must be 0: stage A (adversarial pre-training) is not "
                     "ported yet (ROADMAP Queue 1 item 1)")
    for flag, item in _LATER.items():
        if getattr(args, flag):
            parser.error(f"--{flag.replace('_', '-')} is not ported yet (ROADMAP {item})")
    print(args)
    device = torch.device("cpu" if args.no_cuda else args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(f"Running on {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    if args.synthetic and not os.path.exists(args.data_path):
        write_synthetic_iemocap(
            args.data_path, n_train=args.synthetic_train, n_test=args.synthetic_test,
            seed=args.seed,
        )
        print(f"wrote synthetic features to {args.data_path}")

    torch.manual_seed(args.seed)
    model = GAN_FFN(n_classes=N_CLASSES, dropout=args.dropout, gen_num_layers=args.num_layers,
                    generator=torch.Generator().manual_seed(args.seed), device=device)
    set_dropout_generator(model, torch.Generator().manual_seed(args.seed + 2))
    train_loader, valid_loader, test_loader = get_iemocap_loaders(
        args.data_path, batch_size=args.batch_size, valid=0.1, seed=args.seed,
        strict_parity=args.strict_parity,
    )
    print("Number of parameter: %.2fM" % (sum(p.numel() for p in model.parameters()) / 1e6))

    loss_weights = torch.from_numpy(IEMOCAP_LOSS_WEIGHTS).to(device) if args.class_weight else None
    optimizer = torch_adam(model.parameters(), args.lr, weight_decay=args.l2)
    train_step, eval_step = make_classifier_steps(model, optimizer, N_CLASSES, loss_weights)

    print("=" * 15, "data loaded", "=" * 15)
    best = None  # (loss, labels, preds, masks)
    best_state = None
    for e in range(args.epochs):
        start_time = time.time()
        lr_scale = float(0.98**e) if args.lr_schedule == "decay" else None
        train_res = run_epoch(train_loader, train_step, device, lr_scale=lr_scale)
        valid_res = run_epoch(valid_loader, eval_step, device)
        test_res = run_epoch(test_loader, eval_step, device)
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
