"""One rank of the data-parallel checks of tests/test_torch_parallel.py.

Run as ``python tests/torch_dp_ranks.py DIR`` with torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) on two ranks:
it reads ``DIR/inputs.pt`` (the parent test's weights and batches), joins a
gloo group, runs each check and writes ``DIR/rank{r}.pt``.  It imports torch
and the port only.
"""

from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

from gan_ffn_tpu_torch.cli.common import make_stage_a_step, train_gan
from gan_ffn_tpu_torch.data import get_iemocap_loaders
from gan_ffn_tpu_torch.models import GAN_FFN
from gan_ffn_tpu_torch.nn.core import set_dropout_generator
from gan_ffn_tpu_torch.ops.dropout import STREAM_ATTENTION, StepSeeds, keep_scale
from gan_ffn_tpu_torch.parallel.mesh import DataParallel, init_data_parallel, leave, replicate
from gan_ffn_tpu_torch.parallel.sweep import (gather_seed_results, init_seed_sweep, make_grid_mesh,
                                              make_sweep_train_step)
from gan_ffn_tpu_torch.train.classifier import make_classifier_steps
from gan_ffn_tpu_torch.train.gan import (GANConfig, init_gan_state, make_gan_epoch_step,
                                         make_gan_train_step)
from gan_ffn_tpu_torch.train.optim import torch_adam

TIMEOUT = datetime.timedelta(seconds=120)


def gan_state(dicts, eps, seed=0):
    """The port's six depth-1 networks from ``dicts``, Adam eps ``eps``."""
    state = init_gan_state(GANConfig(num_layers=1, seed=seed), device="cpu")
    for name, sd in dicts.items():
        state.modules[name].load_state_dict(sd, strict=True)
    for opt in state.opts.values():
        for group in opt.param_groups:
            group["eps"] = eps
    return state


def classifier(state_dict, eps):
    model = GAN_FFN(n_classes=6, gen_num_layers=1, device="cpu")
    model.load_state_dict(state_dict)
    return model, torch_adam(model.parameters(), 1e-3, eps=eps, weight_decay=0.008)


def state_dicts(state):
    return {name: {k: v.clone() for k, v in m.state_dict().items()}
            for name, m in state.modules.items()}


def gan_run(inputs, dp, deterministic, perturb=False):
    """One 12-duel step from the parent's weights: losses and weights."""
    state = gan_state(inputs["gan"], inputs["eps"])
    if perturb:  # replicate() must undo this
        with torch.no_grad():
            for m in state.modules.values():
                for p in m.parameters():
                    p.add_(1.0)
    seeds = StepSeeds(torch.Generator().manual_seed(11))
    for m in state.modules.values():
        set_dropout_generator(m, seeds)
    step = make_gan_train_step(state.modules, state.opts, deterministic=deterministic, dp=dp)
    replicate(state.modules.values(), state.opts.values(), dp)
    torch.manual_seed(12)
    losses = step(inputs["gan_batch"])
    return {"losses": [losses[f"duel_{i}"].item() for i in range(12)],
            "state": state_dicts(state)}


def clf_run(inputs, dp, deterministic):
    model, opt = classifier(inputs["clf"], inputs["eps"])
    set_dropout_generator(model, torch.Generator().manual_seed(13))
    train_step, _ = make_classifier_steps(model, opt, 6, inputs["weights"],
                                          deterministic=deterministic, dp=dp)
    torch.manual_seed(14)
    loss, preds = train_step(inputs["clf_batch"])
    return {"loss": loss.item(), "preds": preds.clone(),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def fused_runs(inputs, dp):
    """``train_gan`` for one epoch over the parent's one-bucket loader,
    data-parallel, epoch-fused and per batch, deterministic (rate 0) and
    with every dropout on (the trainers' step, ``make_stage_a_step``):
    weights, loss rows and the all-reduces each run made."""
    calls = [0]
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted
    out = {}
    try:
        for fused in (False, True):
            for deterministic in (True, False):
                state = gan_state(inputs["gan"], inputs["eps"])
                step = None
                if deterministic:
                    make = make_gan_epoch_step if fused else make_gan_train_step
                    step = make(state.modules, state.opts, deterministic=True, dp=dp)
                loader = get_iemocap_loaders(inputs["fixture"], batch_size=4, valid=0.0,
                                             seed=0)[0]  # each run its epoch-0 shuffle
                torch.manual_seed(15)
                calls[0] = 0
                _, history = train_gan(GANConfig(num_layers=1, seed=0), loader, 1, state=state,
                                       device="cpu", log=lambda line: None, epoch_fused=fused,
                                       step=step, dp=dp)
                out[(fused, deterministic)] = {"state": state_dicts(state), "history": history,
                                               "all_reduces": calls[0]}
    finally:
        dist.all_reduce = all_reduce
    state = gan_state(inputs["gan"], inputs["eps"])
    out["step_rank"] = make_stage_a_step(GANConfig(num_layers=1), state, epoch_fused=True,
                                         dp=dp).seeds.rank
    return out


def main() -> None:
    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    dp = init_data_parallel("cpu", timeout=TIMEOUT)
    res = {"rank": dp.rank, "world": dp.world, "backend": dp.backend}
    res["gan"] = gan_run(inputs, dp, deterministic=True, perturb=dp.rank == 1)
    res["clf"] = clf_run(inputs, dp, deterministic=True)
    res["fused"] = fused_runs(inputs, dp)

    # a group of one process against none, every dropout on
    one = dist.new_group(ranks=[0])
    if dp.rank == 0:
        alone = DataParallel(0, 1, one, dp.device, dp.backend)
        res["world_one"] = {"gan": (gan_run(inputs, alone, False), gan_run(inputs, None, False)),
                            "clf": (clf_run(inputs, alone, False), clf_run(inputs, None, False))}

    # rank-folded dropout: rank r's first base and an attention mask from it
    seeds = StepSeeds(torch.Generator().manual_seed(7), rank=dp.rank)
    base = seeds.draw()
    res["fold"] = {"base": base, "mask": keep_scale(base, STREAM_ATTENTION, (4, 64), 0.5)}
    state = gan_state(inputs["gan"], inputs["eps"])  # a step with a group sets the rank
    res["fold"]["step_rank"] = make_gan_train_step(state.modules, state.opts, dp=dp).seeds.rank
    model, opt = classifier(inputs["clf"], inputs["eps"])
    res["fold"]["clf_step_rank"] = make_classifier_steps(model, opt, 6, dp=dp)[0].seeds.rank

    # the seed split over the 1 x 2 and 2 x 1 grids: one deterministic step per seed
    res["grids"] = {}
    for n_seed in (1, 2):
        grid = make_grid_mesh(n_seed, dp=dp)
        models = init_seed_sweep(
            lambda g: GAN_FFN(n_classes=6, gen_num_layers=1, generator=g, device="cpu"),
            inputs["sweep_seeds"], grid)
        steps = [make_classifier_steps(m, torch_adam(m.parameters(), 1e-3, eps=inputs["eps"]), 6,
                                       deterministic=True, dp=grid.data)[0] for m in models]
        outs = make_sweep_train_step(steps)(inputs["clf_batch"])
        local = {s: (loss.item(), {k: v.clone() for k, v in m.state_dict().items()})
                 for s, m, (loss, _) in zip(grid.local_seeds(inputs["sweep_seeds"]), models, outs)}
        res["grids"][f"{n_seed}x{2 // n_seed}"] = {
            "row": grid.row, "column": grid.column, "data_world": grid.data.world,
            "local_seeds": grid.local_seeds(inputs["sweep_seeds"]),
            "results": gather_seed_results(local, grid)}
    dist.barrier()
    leave(dp)
    torch.save(res, os.path.join(out_dir, f"rank{res['rank']}.pt"))


if __name__ == "__main__":
    main()
