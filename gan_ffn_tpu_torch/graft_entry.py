"""A one-card forward check and a data-parallel dry run (counterpart of the
JAX package's ``__graft_entry__.py``).

- :func:`entry` returns ``(fn, example_args)``: the flagship ``GAN_FFN``
  (6 classes, 8-layer generators) in eval mode on the card at the
  reference's batch, L = 112, B = 32, ``valid_len`` 110, and ``fn(model,
  a, v, t, valid_len)``, its forward without gradients.  On the card one
  call launches ``attention_fwd`` 24 times and ``mlp_fwd`` 27 times.
- :func:`dryrun_multichip` ``(n)`` runs ``n`` ranks of ``parallel/``
  (one process each; NCCL, one card a rank, on the card; gloo where the
  caller asks for the CPU) through one step of each training surface the
  JAX dry run covers, at depth 1, L = 8, B = 2n: (a) the ``GAN_FFN``
  classifier step, (b) the 12-duel stage-A step, per batch and
  epoch-fused (two steps through ``make_gan_epoch_step``, graphed on the
  card), (c) the ``GAN_FFN_DialogueRNN`` (BiModel) step, (d) the
  multi-seed sweep (one seed a rank) and (e) the (seed, data) grid (2 x
  n/2 where n >= 4 is even, else 1 x n).  Each surface is certified
  against one process on the same inputs within the JAX dry run's bounds
  (``__graft_entry__.py:180-326``): the loss within 1e-5 relative and the
  largest parameter delta within 1e-4 (BiModel 2.5 * lr, the sweep and
  the grid per seed).  A missed bound raises; the deltas are printed.

The dry run's steps are deterministic (rate 0): a rank draws its dropout
masks by its slice's own indices (``ops.dropout.fold_rank``), so a step
with dropout on is not the one-process step, by design.  Its Adams run
with eps 1e-3: with the default 1e-8 a gradient within rounding of 0,
summed in another order over the ranks, can turn into a full step of the
other sign (the effect the JAX dry run's 2.5 * lr bound for BiModel
allows for), and eps 1e-3 keeps the update proportional to the gradient.

    python -m gan_ffn_tpu_torch.graft_entry [--dryrun N] [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

ENTRY_L, ENTRY_B, ENTRY_VALID_LEN = 112, 32, 110
DRY_L = 8
DRY_EPS = 1e-3  # the dry run's Adam eps (module docstring)
LR = 1e-4
DRNN_LR = 1e-4
LOSS_TOL = 1e-5  # relative to max(1, |one process's loss|)
PARAM_TOL = 1e-4
DRNN_PARAM_TOL = 2.5 * DRNN_LR
RANK_TIMEOUT = datetime.timedelta(seconds=300)


def entry(device="cuda", gen_num_layers: int = 8) -> Tuple[Callable, tuple]:
    """``(fn, (model, a, v, t, valid_len))`` (module docstring): the weights
    from ``torch.Generator().manual_seed(0)``, the features drawn from
    ``np.random.default_rng(0)`` in the JAX function's order."""
    from .models import GAN_FFN
    from .utils.runtime import configure_cuda_runtime, wait_for_device

    device = torch.device(device)
    configure_cuda_runtime()
    if device.type == "cuda":
        wait_for_device(device)
    L, B = ENTRY_L, ENTRY_B
    model = GAN_FFN(n_classes=6, gen_num_layers=gen_num_layers,
                    generator=torch.Generator().manual_seed(0), device=device).eval()
    rng = np.random.default_rng(0)
    a, v, t = (torch.from_numpy(rng.normal(size=(L, B, d)).astype(np.float32)).to(device)
               for d in (100, 512, 100))
    valid_len = torch.tensor(ENTRY_VALID_LEN, dtype=torch.int32, device=device)

    def fn(model, a, v, t, valid_len):
        with torch.inference_mode():
            return model(a, v, t, valid_len=valid_len)

    return fn, (model, a, v, t, valid_len)


# -- the dry run ---------------------------------------------------------------


def _batch(n: int, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A classifier batch at L = 8, B = 2n (every second dialogue 3
    utterances short), with a 2-party qmask, on ``device``."""
    B = 2 * n
    rng = np.random.default_rng(seed)
    lengths = np.where(np.arange(B) % 2 == 0, DRY_L, DRY_L - 3)
    umask = (np.arange(DRY_L)[None, :] < lengths[:, None]).astype(np.float32)
    feats = {k: rng.normal(size=(DRY_L, B, d)).astype(np.float32) * umask.T[:, :, None]
             for k, d in (("text", 100), ("visual", 512), ("audio", 100))}
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (DRY_L, B))] * umask.T[:, :, None]
    host = {**feats, "qmask": qmask, "umask": umask,
            "label": (rng.integers(0, 6, (B, DRY_L)) * umask).astype(np.int64)}
    out = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    out["valid_len"] = torch.tensor(DRY_L, dtype=torch.int32, device=device)
    out["n_real"] = torch.tensor(B, dtype=torch.int32, device=device)
    return out


def _params(modules) -> Dict[str, torch.Tensor]:
    return {f"{i}.{k}": p.detach().clone() for i, m in enumerate(modules)
            for k, p in m.named_parameters()}


def _max_delta(a: Mapping[str, torch.Tensor], b: Mapping[str, torch.Tensor]) -> float:
    return max((a[k] - b[k]).abs().max().item() for k in b)


def _loss_ok(got: float, want: float) -> bool:
    return bool(np.isfinite(got)) and abs(got - want) <= LOSS_TOL * max(1.0, abs(want))


def _classifier(dp, device, batch, drnn: bool = False, seed: int = 0):
    """One deterministic step of ``GAN_FFN`` (or the DialogueRNN
    classifier) over ``dp`` (None: one process): its loss and parameters."""
    from .models import GAN_FFN, GAN_FFN_DialogueRNN
    from .parallel.mesh import replicate
    from .train.classifier import make_classifier_steps
    from .train.optim import torch_adam

    g = torch.Generator().manual_seed(seed)
    if drnn:
        model = GAN_FFN_DialogueRNN(D_m=100, D_g=32, D_p=32, D_e=16, D_h=100, D_a=16,
                                    n_classes=6, gen_num_layers=1, generator=g, device=device)
        opt = torch_adam(model.parameters(), DRNN_LR, eps=DRY_EPS, weight_decay=1e-5)
    else:
        model = GAN_FFN(n_classes=6, gen_num_layers=1, generator=g, device=device)
        opt = torch_adam(model.parameters(), LR, eps=DRY_EPS, weight_decay=0.008)
    train_step, _ = make_classifier_steps(model, opt, 6, deterministic=True, dp=dp)
    replicate([model], [opt], dp)
    loss, _ = train_step(batch)
    return loss.item(), _params([model])


def _gan(dp, device, batches, epoch_fused: bool = False):
    """Deterministic 12-duel steps over ``batches`` (per batch, or through
    the epoch-fused step): the last step's losses and the six networks'
    parameters."""
    from .cli.common import gan_batch_from
    from .parallel.mesh import replicate
    from .train.gan import LOGGED_LOSS_KEYS, GANConfig, init_gan_state, make_gan_epoch_step
    from .train.gan import make_gan_train_step

    state = init_gan_state(GANConfig(num_layers=1, seed=2), device=device)
    for opt in state.opts.values():
        for group in opt.param_groups:
            group["eps"] = DRY_EPS
    make = make_gan_epoch_step if epoch_fused else make_gan_train_step
    step = make(state.modules, state.opts, deterministic=True, dp=dp)
    replicate(state.modules.values(), state.opts.values(), dp)
    for batch in batches:
        losses = step(gan_batch_from(batch))
    return ({k: losses[k].item() for k in LOGGED_LOSS_KEYS},
            _params(state.modules[k] for k in sorted(state.modules)))


def _seed_rows(grid, device, batch, seeds):
    """Each of this rank's seeds of ``grid``: one deterministic ``GAN_FFN``
    step over its row's data group against the same seed in one process,
    gathered to every rank as ``{seed: (loss, one-process loss, delta)}``."""
    from .models import GAN_FFN
    from .parallel.sweep import gather_seed_results, init_seed_sweep, make_sweep_train_step
    from .train.classifier import make_classifier_steps
    from .train.optim import torch_adam

    models = init_seed_sweep(
        lambda g: GAN_FFN(n_classes=6, gen_num_layers=1, generator=g, device=device), seeds, grid)
    opts = [torch_adam(m.parameters(), LR, eps=DRY_EPS, weight_decay=0.008) for m in models]
    steps = [make_classifier_steps(m, o, 6, deterministic=True, dp=grid.data)[0]
             for m, o in zip(models, opts)]
    outs = make_sweep_train_step(steps)(batch)
    local = {}
    for s, m, (loss, _) in zip(grid.local_seeds(seeds), models, outs):
        ref_loss, ref = _classifier(None, device, batch, seed=s)
        local[s] = (loss.item(), ref_loss, _max_delta(_params([m]), ref))
    return gather_seed_results(local, grid)


def _surfaces(dp, device) -> dict:
    """Every surface over ``dp`` against one process (module docstring);
    raises where a bound is missed."""
    from .parallel.sweep import make_grid_mesh, make_seed_mesh

    n = dp.world
    batch, batch2 = _batch(n, device, 0), _batch(n, device, 1)
    failures, report = [], {"world": n, "backend": dp.backend}

    loss, got = _classifier(dp, device, batch)
    ref_loss, ref = _classifier(None, device, batch)
    delta = _max_delta(got, ref)
    report["classifier"] = {"loss": loss, "one_process_loss": ref_loss, "max_param_delta": delta}
    if not _loss_ok(loss, ref_loss) or delta > PARAM_TOL:
        failures.append(("classifier", report["classifier"]))

    losses, got = _gan(dp, device, [batch])
    ref_losses, ref = _gan(None, device, [batch])
    delta = _max_delta(got, ref)
    report["stage_a"] = {"losses": losses, "max_param_delta": delta}
    if not all(_loss_ok(losses[k], ref_losses[k]) for k in ref_losses) or delta > PARAM_TOL:
        failures.append(("stage_a", {**report["stage_a"], "one_process_losses": ref_losses}))

    _, got = _gan(dp, device, [batch, batch2], epoch_fused=True)
    _, ref = _gan(None, device, [batch, batch2])  # the per-batch loop, one process
    delta = _max_delta(got, ref)
    report["stage_a_epoch_fused"] = {"steps": 2, "max_param_delta": delta}
    if delta > PARAM_TOL:
        failures.append(("stage_a_epoch_fused", report["stage_a_epoch_fused"]))

    loss, got = _classifier(dp, device, batch, drnn=True)
    ref_loss, ref = _classifier(None, device, batch, drnn=True)
    delta = _max_delta(got, ref)
    report["bimodel"] = {"loss": loss, "one_process_loss": ref_loss, "max_param_delta": delta}
    if not _loss_ok(loss, ref_loss) or delta > DRNN_PARAM_TOL:
        failures.append(("bimodel", report["bimodel"]))

    n_seed = 2 if n >= 4 and n % 2 == 0 else 1
    for name, grid, seeds in (("seed_sweep", make_seed_mesh(dp), list(range(n))),
                              ("grid", make_grid_mesh(n_seed, dp=dp), list(range(n_seed)))):
        rows = _seed_rows(grid, device, batch, seeds)
        report[name] = {"grid": [grid.n_seed, grid.n_data], "losses": {s: r[0] for s, r in rows.items()},
                        "max_param_delta": max(r[2] for r in rows.values())}
        if (sorted(rows) != seeds or not all(_loss_ok(r[0], r[1]) for r in rows.values())
                or report[name]["max_param_delta"] > PARAM_TOL):
            failures.append((name, {**report[name], "rows": rows}))
    if failures:
        raise RuntimeError(f"dryrun_multichip({n}) on rank {dp.rank}: a surface diverged from "
                           f"one process: {failures}")
    return report


def _rank_main(rank: int, world: int, device_type: str, port: int, out_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: joins the group, runs every
    surface, and rank 0 writes the report."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if device_type == "cpu":
        torch.set_num_threads(1)
    from .parallel.mesh import init_data_parallel, leave
    from .utils.runtime import configure_cuda_runtime

    configure_cuda_runtime()
    dp = init_data_parallel(device_type, timeout=RANK_TIMEOUT)
    try:
        report = _surfaces(dp, dp.device)
    finally:
        leave(dp)
    if rank == 0:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run (module docstring) over ``n_devices`` ranks, one
    process each (``python -m gan_ffn_tpu_torch.graft_entry --rank R``), on
    as many cards (``device`` cuda) or on the CPU over gloo (``device``
    cpu); print its line and return rank 0's report.  Raises where a rank
    fails or a bound is missed; there is no fallback to fewer ranks or to
    the CPU.  Every process it starts has ended when it returns."""
    device_type = torch.device(device).type
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, got {n_devices}")
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards, "
                           f"{torch.cuda.device_count()} visible")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gan_ffn_tpu_torch.graft_entry", "--rank", str(r), "--world",
             str(n_devices), "--device", device_type, "--port", str(port), "--out", out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT.total_seconds() * 2)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode, log[-4000:]) for r, (p, log) in enumerate(zip(procs, logs))
                  if p.returncode != 0]
        if failed:
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks failed: {failed}")
        with open(os.path.join(out_dir, "report.json")) as f:
            report = json.load(f)
    print(f"dryrun_multichip({n_devices}): {report['backend']} ranks; DP classifier loss "
          f"{report['classifier']['loss']:.4f} == one process "
          f"{report['classifier']['one_process_loss']:.4f} (max param delta "
          f"{report['classifier']['max_param_delta']:.2e}); 12-duel DP == one process (max param "
          f"delta {report['stage_a']['max_param_delta']:.2e}); epoch-fused DP 12-duel == the "
          f"per-batch loop (max param delta {report['stage_a_epoch_fused']['max_param_delta']:.2e}); "
          f"BiModel DP loss {report['bimodel']['loss']:.4f} == one process "
          f"{report['bimodel']['one_process_loss']:.4f} (max param delta "
          f"{report['bimodel']['max_param_delta']:.2e}); seed sweep {report['seed_sweep']['grid']} "
          f"(max param delta {report['seed_sweep']['max_param_delta']:.2e}); (seed, data) grid "
          f"{report['grid']['grid']} (max param delta {report['grid']['max_param_delta']:.2e})",
          flush=True)
    return report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="GAN_FFN forward check and data-parallel dry run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--dryrun", type=int, default=0, metavar="N",
                   help="also run the data-parallel dry run over N ranks")
    # one rank of the dry run, as dryrun_multichip starts it
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.device, args.port, args.out)
        return
    fn, example = entry(args.device, args.num_layers)
    out = fn(*example)
    print("entry forward:", tuple(out.shape), out.dtype, flush=True)
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device)


if __name__ == "__main__":
    main()
