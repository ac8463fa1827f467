"""Host time per batch of the per-batch epochs (the trainers' default path,
without ``--epoch-fused``) on the card, for stage A and for stage B of both
classifiers at full width.

    python -m gan_ffn_tpu_torch.cli.epoch_time [--label NAME] [--epochs 3]

Writes a synthetic IEMOCAP fixture into a temporary directory (120 + 31
dialogues of 97-110 utterances, so every batch is of L = 112), builds each
step from seeded random weights with every dropout on, runs one warm-up
epoch and then times ``--epochs`` epochs, each to the end of its one
device-to-host copy: stage A through ``cli.common.train_gan`` (B = 32, the
six 8-layer networks), stage B through ``train.loop.run_epoch`` over
``train.classifier.make_classifier_steps`` for the 8-layer ``GAN_FFN`` (B =
32) and ``GAN_FFN_DialogueRNN`` (B = 30).  Each epoch's time covers the
batches' copies to the card, the steps and the epoch's copy back.  Prints
one JSON line per step: the host ms per batch of each timed epoch and their
median.  The first line names the card and its power limit.

The script uses only what the port has had since the DialogueRNN trainer,
and imports the ``gan_ffn_tpu_torch`` that is first on ``sys.path``, so one
call can time another checkout in turns (parent, change, change, parent),
run as ``cli/mlp_profile.py`` describes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch


def _time_epochs(run_epoch, n_batches: int, epochs: int) -> list:
    """Host ms per batch of each of ``epochs`` calls of ``run_epoch()``,
    after one warm-up call."""
    run_epoch()
    torch.cuda.synchronize()
    out = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        run_epoch()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / n_batches)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--label", default="tree", help="a name for this checkout in the output")
    p.add_argument("--epochs", type=int, default=3, help="timed epochs of each step")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("epoch_time: no CUDA card")

    from gan_ffn_tpu_torch.cli.common import IEMOCAP_LOSS_WEIGHTS, IEMOCAP_N_CLASSES, train_gan
    from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
    from gan_ffn_tpu_torch.models import GAN_FFN, GAN_FFN_DialogueRNN
    from gan_ffn_tpu_torch.nn.core import set_dropout_generator
    from gan_ffn_tpu_torch.train.classifier import make_classifier_steps
    from gan_ffn_tpu_torch.train.gan import GANConfig, init_gan_state
    from gan_ffn_tpu_torch.train.loop import run_epoch
    from gan_ffn_tpu_torch.train.optim import torch_adam
    from gan_ffn_tpu_torch.utils.runtime import configure_cuda_runtime

    configure_cuda_runtime()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    import gan_ffn_tpu_torch

    print(json.dumps({"label": args.label, "card": smi,
                      "package": os.path.dirname(gan_ffn_tpu_torch.__file__)}), flush=True)
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        data = write_synthetic_iemocap(os.path.join(tmp, "iemocap.pkl"), n_train=120, n_test=31,
                                       min_len=97, max_len=110, seed=0)
        runs = {}
        cfg = GANConfig(num_layers=8, seed=0)
        state = init_gan_state(cfg, device)
        loader = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)[0]
        runs["stage_a"] = (32, len(loader), lambda ld=loader: train_gan(
            cfg, ld, 1, state=state, device=device, log=lambda line: None,
            log_every_batch=False))
        weights = torch.from_numpy(IEMOCAP_LOSS_WEIGHTS).to(device)
        for name, cls, B, l2 in (("stage_b", GAN_FFN, 32, 0.008),
                                 ("dialoguernn", GAN_FFN_DialogueRNN, 30, 1e-5)):
            model = cls(n_classes=IEMOCAP_N_CLASSES, gen_num_layers=8,
                        generator=torch.Generator().manual_seed(1), device=device)
            set_dropout_generator(model, torch.Generator().manual_seed(2))
            opt = torch_adam(model.parameters(), 1e-4, weight_decay=l2)
            train_step = make_classifier_steps(model, opt, IEMOCAP_N_CLASSES, weights)[0]
            loader = get_iemocap_loaders(data, batch_size=B, valid=0.1, seed=0)[0]
            runs[name] = (B, len(loader), lambda ld=loader, st=train_step: run_epoch(ld, st, device))
        for name, (B, n_batches, run) in runs.items():
            ms = _time_epochs(run, n_batches, args.epochs)
            print(json.dumps({"label": args.label, "step": name, "B": B, "L": 112,
                              "batches_per_epoch": n_batches, "host_ms_per_batch": ms,
                              "median_host_ms_per_batch": statistics.median(ms)}), flush=True)


if __name__ == "__main__":
    main()
