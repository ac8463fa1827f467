"""Where one train step's device time goes, on the card, for stage B of
both classifiers and for stage A.

    python -m gan_ffn_tpu_torch.cli.step_profile [--label NAME] [--steps 5] [--bf16]
        [--only stage_b,dialoguernn,stage_a] [--eager]

Builds the full-width 8-layer ``GAN_FFN`` (random weights from a seed) and
trains it on one random batch at B = 32, L = 112 (dialogues of 97-110
utterances, every dropout on), as ``chip_smoke.py``'s train step does; then
the six full-width stage-A networks, through the 12-duel step on the same
batch; then the full-width ``GAN_FFN_DialogueRNN`` (8-layer generators,
D_g = D_p = 500, context attention ``general``) on one such batch at B =
30, the DialogueRNN trainer's.  For each, after 3 warm-up steps it profiles ``--steps`` steps with
torch.profiler and prints one JSON line: wall ms per step (host clock, to
the end of a synchronize), the device's busy ms per step (the union of its
kernels' intervals) and idle share, the port's four kernels' ms per step and
share of the busy time, and device ms per step by kernel, largest first
(the port's kernels under their library's name, cuBLAS's and PyTorch's
under their own).  Then the same three steps graphed, as ``--epoch-fused``
runs them (``train/graphs.py``): the first call runs eagerly and captures
the step's CUDA graph, and the profiled calls replay it; their lines add
the capture seconds and the graph pool's bytes.  The first line names the
card and its power limit.  ``--bf16`` trains each step at bfloat16, as the
trainers' ``--bf16`` does (float32 parameters cast at each use), ``--only``
profiles the named steps alone and ``--eager`` skips the graphed ones.

Like ``cli/mlp_profile.py``, it imports the ``gan_ffn_tpu_torch`` first
on ``sys.path``, so it can time another checkout (see there).
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch

B, L = 32, 112
STEPS = {"stage_b": B, "dialoguernn": 30, "stage_a": B}  # each step's batch size


def _batch(rng: np.random.Generator, B: int = B) -> dict:
    """A random batch on the card as ``train.loop.batch_to_tensors`` gives
    it: dialogues of 97-110 utterances at L = 112, two speakers."""
    lengths = rng.integers(97, 111, B)
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    host = {
        "audio": rng.standard_normal((L, B, 100)).astype(np.float32),
        "visual": rng.standard_normal((L, B, 512)).astype(np.float32),
        "text": rng.standard_normal((L, B, 100)).astype(np.float32),
        "umask": umask, "label": rng.integers(0, 6, (B, L)) * umask.astype(np.int64),
    }
    speakers = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (L, B))]
    host["qmask"] = speakers * umask.T[:, :, None]
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    batch["host_valid_len"], batch["host_n_real"] = int(lengths.max()), B
    batch["valid_len"] = torch.tensor(int(lengths.max()), dtype=torch.int32).cuda()
    batch["n_real"] = torch.tensor(B, dtype=torch.int32).cuda()
    return batch


def step_batch(name: str, rng: np.random.Generator) -> dict:
    """A batch of :func:`_batch` for step ``name`` (stage A's part of it)."""
    from gan_ffn_tpu_torch.cli.common import gan_batch_from

    batch = _batch(rng, STEPS[name])
    return gan_batch_from(batch) if name == "stage_a" else batch


def build_step(name: str, graphed: bool, deterministic: bool = False, capturable: bool = False,
               eps: float = 1e-8, dtype=None, dp=None):
    """``(step, named parameters, optimizers)`` of a full-width step from
    fixed weights: ``stage_b`` (``GAN_FFN``), ``dialoguernn``
    (``GAN_FFN_DialogueRNN``) or ``stage_a`` (the 12 duels), per batch or
    ``graphed`` (the epoch-fused step, whose Adams are capturable).
    ``capturable`` gives a per-batch step the capturable Adams too, so that
    it differs from the graphed step by the graph alone; ``eps`` is Adam's;
    ``dtype`` the compute dtype (None: float32); ``dp`` (stage A only) a
    ``parallel.mesh.DataParallel`` that makes the step data-parallel."""
    from gan_ffn_tpu_torch.cli.common import IEMOCAP_LOSS_WEIGHTS, IEMOCAP_N_CLASSES
    from gan_ffn_tpu_torch.models import GAN_FFN, GAN_FFN_DialogueRNN
    from gan_ffn_tpu_torch.nn.core import set_dropout_generator
    from gan_ffn_tpu_torch.ops.dropout import StepSeeds
    from gan_ffn_tpu_torch.train.classifier import make_classifier_epoch_steps, make_classifier_steps
    from gan_ffn_tpu_torch.train.gan import (GANConfig, init_gan_state, make_gan_epoch_step,
                                             make_gan_train_step)
    from gan_ffn_tpu_torch.train.optim import make_capturable, torch_adam

    if name == "stage_a":
        state = init_gan_state(GANConfig(num_layers=8, seed=3, dtype=dtype), device="cuda")
        seeds = StepSeeds(torch.Generator().manual_seed(4))
        for module in state.modules.values():
            set_dropout_generator(module, seeds)
        opts = list(state.opts.values())
        for opt in opts:
            for group in opt.param_groups:
                group["eps"] = eps
        make = make_gan_epoch_step if graphed else make_gan_train_step
        step = make(state.modules, state.opts, deterministic=deterministic, dp=dp)
        params = {f"{n}.{k}": p for n, m in state.modules.items() for k, p in m.named_parameters()}
    else:
        cls, l2 = {"stage_b": (GAN_FFN, 0.008), "dialoguernn": (GAN_FFN_DialogueRNN, 1e-5)}[name]
        model = cls(n_classes=IEMOCAP_N_CLASSES, gen_num_layers=8,
                    generator=torch.Generator().manual_seed(1), device="cuda", dtype=dtype)
        set_dropout_generator(model, torch.Generator().manual_seed(2))
        opts = [torch_adam(model.parameters(), 1e-4, eps=eps, weight_decay=l2)]
        make = make_classifier_epoch_steps if graphed else make_classifier_steps
        step = make(model, opts[0], IEMOCAP_N_CLASSES,
                    torch.from_numpy(IEMOCAP_LOSS_WEIGHTS).cuda(), deterministic=deterministic)[0]
        params = dict(model.named_parameters())
    if capturable:
        for opt in opts:
            make_capturable(opt)
    return step, params, opts


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


# the port's kernels: each library's entry points
LIBRARY = {"attention_fwd_kernel": "attention_fwd", "attention_bwd_kernel": "attention_bwd",
           "mlp_fwd_kernel": "mlp_fwd", "mlp_fwd_reduce_kernel": "mlp_fwd",
           "gemm_kernel": "mlp_bwd", "reduce_kernel": "mlp_bwd", "pre_kernel": "mlp_bwd",
           "attention_fwd_bf16_kernel": "attention_fwd_bf16",
           "attention_bwd_bf16_kernel": "attention_bwd_bf16",
           "mlp_fwd_bf16_kernel": "mlp_fwd_bf16", "mlp_fwd_bf16_reduce_kernel": "mlp_fwd_bf16",
           "z1_kernel": "mlp_bwd_bf16", "colsum_kernel": "mlp_bwd_bf16"}
# in a bf16 step the kernels of both MLP backwards' names are mlp_bwd_bf16's
BF16_LIBRARY = {**LIBRARY, "gemm_kernel": "mlp_bwd_bf16", "reduce_kernel": "mlp_bwd_bf16"}
# kernels that both MLP libraries launch (csrc/mlp_tile.cuh): each launch is
# counted with the library of the kernel that runs next on the stream
SHARED = {"mlp::pre_kernel"}


def _kernel_name(name: str, bf16: bool = False) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters; the port's kernels as their library's name."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    name = name.split("(")[0].split("<")[0]
    return (BF16_LIBRARY if bf16 else LIBRARY).get(name, name[:80])


def _profile(step, steps: int, bf16: bool = False) -> dict:
    """Device time of ``steps`` calls of ``step()`` after 3 warm-up calls
    (``bf16``: a bf16 step, for the kernels' names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device activities: kernels, copies and sets; not the device-side spans
    # of user annotations (the optimizer's step), which cover the gaps too
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: e.time_range.start)
    names = [_kernel_name(e.name, bf16) for e in kernels]
    per_name = collections.Counter()
    for i, e in enumerate(kernels):
        name = names[i]
        if name in SHARED and i + 1 < len(kernels):
            name = names[i + 1]
        per_name[name] += e.time_range.elapsed_us() / 1e3 / steps
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / steps
    port_ms = sum(per_name[name] for name in set(LIBRARY.values()))
    return {
        "steps": steps, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "kernels_per_step": len(kernels) / steps,
        "port_kernels_ms_per_step": port_ms, "port_kernels_share_of_busy": port_ms / busy_ms,
        "device_ms_per_step_by_kernel": {k: round(v, 4) for k, v in per_name.most_common(25)},
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--label", default="tree", help="a name for this checkout in the output")
    p.add_argument("--steps", type=int, default=5, help="profiled train steps")
    p.add_argument("--bf16", action="store_true", help="train at bfloat16")
    p.add_argument("--only", default=",".join(STEPS), help="the steps to profile, comma-separated")
    p.add_argument("--eager", action="store_true", help="skip the graphed steps")
    args = p.parse_args(argv)
    names = args.only.split(",")
    if not set(names) <= set(STEPS):
        p.error(f"--only takes steps of {sorted(STEPS)}")
    dtype = torch.bfloat16 if args.bf16 else None
    if not torch.cuda.is_available():
        sys.exit("step_profile: no CUDA card")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi}), flush=True)
    for graphed in (False,) if args.eager else (False, True):
        for name in names:
            batch = step_batch(name, np.random.default_rng(0))
            step = build_step(name, graphed, dtype=dtype)[0]
            line = {"label": args.label, "B": STEPS[name], "L": L,
                    "valid_len": int(batch["valid_len"].item()), "step": name,
                    "graphed": graphed, "bf16": args.bf16,
                    **_profile(lambda: step(batch), args.steps, args.bf16)}
            if graphed:
                line["graphs"] = step.graphs.stats()
            print(json.dumps(line), flush=True)
            del step
            torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
