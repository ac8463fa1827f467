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
them.  ``--gan-schedule`` is accepted, and both values run the same eager
loop.  ``--device`` (default ``cuda``) picks the device; ``--no-cuda`` is the
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

from ..data import get_iemocap_loaders, write_synthetic_iemocap
from ..evaluation.metrics import f1_score
from ..evaluation.reports import format_test_report, write_test_report
from ..models import GAN_FFN
from ..nn.core import set_dropout_generator
from ..train.classifier import GENERATOR_GAN_KEYS, graft_generator_params, make_classifier_steps
from ..train.gan import GANConfig, init_gan_state
from ..train.loop import run_epoch
from ..train.optim import torch_adam
from ..utils.artifacts import draw_gan_loss, load_gan_loss_csv, save_gan_loss_csv
from ..utils.checkpoint import load_gan_state, save_gan_state
from .common import train_gan

# IEMOCAP class weights (train_IEMOCAP.py:653)
IEMOCAP_LOSS_WEIGHTS = np.array(
    [1.2, 0.60072, 0.38066, 0.94019, 0.67924, 0.34332], dtype=np.float32
)
N_CLASSES = 6

# flag -> the ROADMAP item that brings it
_LATER = {
    "epoch_fused": "module note 12 (epoch-fused stages)",
    "dp": "module note 13 (parallel and sweeps)",
    "scan_layers": "module note 15 (the scanned layer layout)",
    "bf16": "Queue 1 item 4 (bf16 kernels)",
    "tensorboard": "module note 15 (utilities)",
    "profile": "module note 15 (utilities)",
}


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


def stage_a(args, device):
    """Stage A as the reference runs it: train the six GAN networks (or load
    them, and continue), then save them and their loss history."""
    gan_cfg = GANConfig(num_layers=args.num_layers, seed=args.seed)  # lr 1e-4, betas (0.5, 0.6)
    gan_train_loader, _, _ = get_iemocap_loaders(
        args.data_path, batch_size=32, valid=0.1, seed=args.seed,
        strict_parity=args.strict_parity,
    )
    loss_csv = os.path.join(args.output_dir, "GAN_loss.csv")
    torch.manual_seed(args.seed + 1)
    if args.use_trained_GAN:
        gan_state = load_gan_state(args.model_save_path, *init_gan_state(gan_cfg, device),
                                   reset_opt=True)
        print("=" * 15, args.model_save_path + " loaded trained GAN", "=" * 15)
        if args.continue_train_GAN_step <= 0:
            return gan_state
        history = load_gan_loss_csv(loss_csv) if os.path.exists(loss_csv) else []
        print("=" * 15, "continue train GAN", "=" * 15)
        gan_state, history = train_gan(
            gan_cfg, gan_train_loader, args.continue_train_GAN_step, state=gan_state,
            history=history, start_epoch=(history[-1]["epoch"] + 1) if history else 0,
            device=device,
        )
    else:
        gan_state, history = train_gan(gan_cfg, gan_train_loader, args.GAN_epochs, device=device)
    save_gan_loss_csv(history, loss_csv)
    draw_gan_loss(history, os.path.join(args.output_dir, "GAN_loss.png"))
    save_gan_state(args.model_save_path, gan_state)
    print("=" * 15, "finished training GAN", "=" * 15)
    return gan_state


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
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

    gan_state = stage_a(args, device)

    # ---- Stage B: GAN_FFN with the trained generators ----
    torch.manual_seed(args.seed)
    model = GAN_FFN(n_classes=N_CLASSES, dropout=args.dropout, gen_num_layers=args.num_layers,
                    generator=torch.Generator().manual_seed(args.seed), device=device)
    gan_weights = {f"{name}.{k}": v for name in GENERATOR_GAN_KEYS
                   for k, v in gan_state.modules[name].state_dict().items()}
    model.load_state_dict(graft_generator_params(model.state_dict(), gan_weights))
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
