"""Multi-seed sweep on PyTorch (counterpart of ``gan_ffn_tpu/cli/seed_sweep.py``;
BASELINE.json config 5).

Trains one ``GAN_FFN`` classifier per seed of ``--seeds`` on the same
batches, from one stage A: the six networks of ``--model-save-path`` with
``--use-trained-GAN`` where ``acoustic_gen.msgpack`` is there (the port's
trainers' or the JAX package's)
(``cli/common.stage_a``), else ``--GAN-epochs`` of stage A, saved there.
Seed ``s`` has its own model (weights from ``torch.Generator().manual_seed(s)``,
the generators grafted), Adam, kernel seed source (a generator seeded
``1000 + s``) and torch RNG (seeded ``s``), so its results never depend on
which other seeds run.  Per epoch it prints each seed's train loss, test
loss and test F1; each seed keeps the epoch with the lowest test loss.
Returns ``{seed: F1}``.

The JAX package vmaps one step over the seeds, one seed per device.  Under
``python -m torch.distributed.run`` the seeds split over the ranks
(``parallel.sweep.make_seed_mesh``: ``seeds[r::world]`` on rank ``r``) and
rank 0 prints; each rank loops over its own seeds, one seed's kernels after
another's.  ``--bf16``, ``--device`` and ``--no-cuda`` as the trainers take
them.

Run: ``python -m gan_ffn_tpu_torch.cli.seed_sweep --seeds 0 1 2 3 --epochs 160``
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data import get_iemocap_loaders
from ..evaluation.metrics import f1_score
from ..models import GAN_FFN
from ..nn.core import set_dropout_generator
from ..parallel.mesh import init_data_parallel, leave
from ..parallel.sweep import (TorchRNG, gather_seed_results, init_seed_sweep, make_seed_mesh,
                              make_sweep_train_step)
from ..train.classifier import make_classifier_steps
from ..train.loop import batch_to_tensors
from ..train.optim import torch_adam
from .common import (IEMOCAP_LOSS_WEIGHTS, IEMOCAP_N_CLASSES, compute_dtype, generator_weights,
                     graft_generators, setup, stage_a)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multi-seed GAN-FFN sweep (PyTorch)")
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3],
                   help="classifier init seeds; split over the ranks of torch.distributed.run")
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--GAN-epochs", type=int, default=150)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--l2", type=float, default=0.008)
    p.add_argument("--dropout", type=float, default=0.6)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--data-path", default="data/iemocap/IEMOCAP_features.pkl")
    p.add_argument("--synthetic", action="store_true", default=False)
    p.add_argument("--model-save-path", default="./GAN_save/")
    p.add_argument("--use-trained-GAN", action="store_true", default=False)
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--bf16", action="store_true", default=False)
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="run on the CPU (the same as --device cpu)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=3407, help="data/GAN seed")
    p.add_argument("--synthetic-train", type=int, default=120)
    p.add_argument("--synthetic-test", type=int, default=31)
    return p


def _epoch_losses(outs, mask_sums) -> float:
    """``sum_b(loss_b * mask_sum_b) / sum_b(mask_sum_b)`` over one seed's
    batches (float64 on the host)."""
    losses = torch.stack([out[0] for out in outs]).double().cpu().numpy()
    return float(np.sum(losses * mask_sums) / np.sum(mask_sums))


def main(argv=None) -> dict:
    parser = build_parser()
    args, device = setup(parser, argv)
    dp = init_data_parallel(device)
    device, grid = dp.device, make_seed_mesh(dp)
    load = args.use_trained_GAN and os.path.exists(
        os.path.join(args.model_save_path, "acoustic_gen.msgpack"))
    if load or dp.rank == 0:  # rank 0 trains and saves stage A; the others load it
        gan_state = stage_a(args, device, load, continue_epochs=0)
    if dp.group is not None:
        dist.barrier()
    if not (load or dp.rank == 0):
        gan_state = stage_a(args, device, True, continue_epochs=0)
    generators = generator_weights(gan_state)
    del gan_state

    train_loader, _, test_loader = get_iemocap_loaders(
        args.data_path, batch_size=args.batch_size, valid=0.1, seed=args.seed)
    weights = torch.from_numpy(IEMOCAP_LOSS_WEIGHTS).to(device)
    dtype = compute_dtype(args)
    seeds = grid.local_seeds(args.seeds)

    def init_fn(generator):
        model = GAN_FFN(n_classes=IEMOCAP_N_CLASSES, dropout=args.dropout,
                        gen_num_layers=args.num_layers, generator=generator, device=device,
                        dtype=dtype)
        graft_generators(model, generators)
        return model

    models = init_seed_sweep(init_fn, args.seeds, grid)
    train_steps, eval_steps = [], []
    for s, model in zip(seeds, models):
        set_dropout_generator(model, torch.Generator().manual_seed(1000 + s))
        optimizer = torch_adam(model.parameters(), args.lr, weight_decay=args.l2)
        train_step, eval_step = make_classifier_steps(model, optimizer, IEMOCAP_N_CLASSES,
                                                      weights, dp=grid.data)
        train_steps.append(train_step)
        eval_steps.append(eval_step)
    sweep_step = make_sweep_train_step(train_steps, [TorchRNG(s, device) for s in seeds])

    best = {}  # seed -> (test loss, f1)
    for e in range(args.epochs):
        t0 = time.time()
        train_outs, train_masks = [[] for _ in seeds], []
        for batch in train_loader:
            for i, out in enumerate(sweep_step(batch_to_tensors(batch, device))):
                train_outs[i].append(out)
            train_masks.append(batch.umask.sum())
        test_outs, test_batches = [[] for _ in seeds], list(test_loader)
        for batch in test_batches:
            tensors = batch_to_tensors(batch, device)
            for i, eval_step in enumerate(eval_steps):
                test_outs[i].append(eval_step(tensors))
        labels = np.concatenate([b.label.reshape(-1) for b in test_batches])
        masks = np.concatenate([b.umask.reshape(-1) for b in test_batches])
        test_masks = np.array([b.umask.sum() for b in test_batches])
        local = {}
        for i, s in enumerate(seeds):
            preds = torch.cat([out[1] for out in test_outs[i]]).cpu().numpy()
            test_loss = _epoch_losses(test_outs[i], test_masks)
            f1 = round(f1_score(labels, preds, sample_weight=masks, average="weighted") * 100, 2)
            local[s] = (_epoch_losses(train_outs[i], np.array(train_masks)), test_loss, f1)
            if s not in best or best[s][0] > test_loss:
                best[s] = (test_loss, f1)
        epoch = gather_seed_results(local, grid)
        if dp.rank == 0:
            rows = [epoch[s] for s in args.seeds]
            print(f"epoch {e + 1} train_loss/seed {np.round([r[0] for r in rows], 4).tolist()} "
                  f"test_loss/seed {np.round([r[1] for r in rows], 4).tolist()} "
                  f"test_f1/seed {[r[2] for r in rows]} time {time.time() - t0:.2f}s")

    best = gather_seed_results(best, grid)
    leave(dp)
    if not best:
        parser.error("--epochs must be at least 1")
    results = {s: best[s][1] for s in args.seeds}
    if dp.rank == 0:
        print("best F1 per seed:", results)
        print("best test loss per seed:", {s: best[s][0] for s in args.seeds})
    return results


if __name__ == "__main__":
    main()
