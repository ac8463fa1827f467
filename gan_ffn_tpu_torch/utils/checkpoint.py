"""Stage A's checkpoints, with the reference's resume semantics (counterpart
of ``gan_ffn_tpu/utils/checkpoint.py``; reference train_IEMOCAP.py:427-438,
527-570).

One file per network, each network's ``state_dict`` and its Adam's, written
with ``torch.save``:

    {save_dir}/acoustic_gen.pt, {save_dir}/acoustic_disc.pt, ...
    {save_dir}/opt/acoustic_gen.pt, ...

They are read back with ``torch.load(weights_only=True)`` and
``load_state_dict`` (strict), onto the modules' own device.
``reset_opt=True`` keeps the fresh Adams, as the reference does on resume
(it re-creates the six Adams inside train_GAN).  The JAX package's msgpack
files are not read here (ROADMAP module note 8).
"""

from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn

from ..train.gan import DISC_NAMES, GEN_NAMES, GANState


def _paths(save_dir: str, name: str):
    return os.path.join(save_dir, f"{name}.pt"), os.path.join(save_dir, "opt", f"{name}.pt")


def save_gan_state(save_dir: str, state: GANState) -> None:
    """Write all six networks' weights and Adam states under ``save_dir``."""
    os.makedirs(os.path.join(save_dir, "opt"), exist_ok=True)
    for name in GEN_NAMES + DISC_NAMES:
        weights, opt = _paths(save_dir, name)
        torch.save(state.modules[name].state_dict(), weights)
        torch.save(state.opts[name].state_dict(), opt)


def load_gan_state(save_dir: str, modules: Dict[str, nn.Module],
                   opts: Dict[str, torch.optim.Adam], reset_opt: bool = False) -> GANState:
    """Load what :func:`save_gan_state` wrote into ``modules`` and, unless
    ``reset_opt``, ``opts`` (in place); returns them as a :class:`GANState`."""
    for name in GEN_NAMES + DISC_NAMES:
        weights, opt = _paths(save_dir, name)
        device = next(modules[name].parameters()).device
        modules[name].load_state_dict(
            torch.load(weights, map_location=device, weights_only=True), strict=True)
        if not reset_opt:
            opts[name].load_state_dict(torch.load(opt, map_location=device, weights_only=True))
    return GANState(modules, opts)
