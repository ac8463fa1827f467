"""Full-width train steps on the card, for stage B of both classifiers and
for stage A, with the random batches they run on (``chip_smoke.py`` times
and checks them).

:func:`build_step` builds the full-width 8-layer ``GAN_FFN`` (random
weights from a seed), the six full-width stage-A networks through the
12-duel step, or the full-width ``GAN_FFN_DialogueRNN`` (8-layer
generators, D_g = D_p = 500, context attention ``general``), per batch or
graphed, as ``--epoch-fused`` runs them (``train/graphs.py``).
:func:`step_batch` gives each a random batch at L = 112 (dialogues of
97-110 utterances, two speakers) and its batch size in :data:`STEPS`: B =
32, and B = 30 for the DialogueRNN, the DialogueRNN trainer's.
"""

from __future__ import annotations

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
