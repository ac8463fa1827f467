"""Import the reference implementation's trained stage-A networks
(counterpart of ``gan_ffn_tpu/utils/torch_import.py``).

The reference saves whole torch modules, wrapped in ``nn.DataParallel``,
to ``GAN_save/{modality}_{gen,disc}.pth`` (train_IEMOCAP.py:427-438).
:func:`import_gan_save` unpickles each of the six (torch pickles by class
path, so the reference's ``model`` module must be importable: pass the
reference's source tree as ``reference_path`` and it goes on
``sys.path``), unwraps ``DataParallel``, loads the weights strictly into
the port's network of the same name and depth, and writes it as
``{net}.msgpack`` through ``utils/checkpoint.py``: the JAX package's
format, so ``--use-trained-GAN`` of either package reads the result.

The weights map by name, as the JAX importer maps them: the reference's
``transformer_encoder.layers[i]`` (``self_attn``'s ``in_proj_weight``,
``in_proj_bias`` and ``out_proj``, ``linear1``, ``linear2``, ``norm1``,
``norm2``), ``fc1``, ``fc2`` (and a discriminator's ``fc3``) are the port's
``net.*`` of the same names, and the visual discriminator's ``object`` is
its ``object``.  Nothing else of the reference module (its positional
table, its dropouts) is read.  The depth and ``D_h`` come from the
reference module.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import torch
from torch import nn

from ..models import (AcousticDiscriminator, AcousticGenerator, TextDiscriminator,
                      TextGenerator, VisualDiscriminator, VisualGenerator)
from .checkpoint import save_params

NETWORKS = {
    "acoustic_gen": AcousticGenerator,
    "visual_gen": VisualGenerator,
    "text_gen": TextGenerator,
    "acoustic_disc": AcousticDiscriminator,
    "visual_disc": VisualDiscriminator,
    "text_disc": TextDiscriminator,
}
_LAYER_PARTS = ("self_attn.in_proj_weight", "self_attn.in_proj_bias", "self_attn.out_proj.weight",
                "self_attn.out_proj.bias", "linear1.weight", "linear1.bias", "linear2.weight",
                "linear2.bias", "norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias")


def _unwrap(module: nn.Module) -> nn.Module:
    """The module inside an ``nn.DataParallel`` (the reference wraps its
    networks before saving them), or ``module`` itself."""
    return getattr(module, "module", module)


def _get(module: nn.Module, dotted: str) -> torch.Tensor:
    for part in dotted.split("."):
        module = getattr(module, part)
    return module.detach()


def reference_state_dict(ref: nn.Module) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of the reference network ``ref`` (see the
    module docstring)."""
    out = {}
    for i, layer in enumerate(ref.transformer_encoder.layers):
        for part in _LAYER_PARTS:
            out[f"net.transformer_encoder.layers.{i}.{part}"] = _get(layer, part)
    for fc in ("fc1", "fc2", "fc3"):
        if hasattr(ref, fc):
            for p in ("weight", "bias"):
                out[f"net.{fc}.{p}"] = _get(ref, f"{fc}.{p}")
    if hasattr(ref, "object"):
        out["object.weight"], out["object.bias"] = _get(ref, "object.weight"), _get(ref, "object.bias")
    return {k: v.float().cpu() for k, v in out.items()}


def port_network(name: str, ref: nn.Module) -> nn.Module:
    """The port's network ``name`` at ``ref``'s depth and ``D_h``, holding
    ``ref``'s weights (loaded strictly), on the CPU."""
    cls = NETWORKS[name]
    generator = name.endswith("_gen")
    D_h = ref.fc2.out_features if generator else ref.fc1.in_features
    net = cls(D_h=D_h, num_layers=len(ref.transformer_encoder.layers), device="cpu")
    net.load_state_dict(reference_state_dict(ref), strict=True)
    return net.eval()


def import_gan_save(src_dir: str, dst_dir: str,
                    reference_path: Optional[str] = None) -> Dict[str, str]:
    """Convert the reference's ``{net}.pth`` files in ``src_dir`` (those of
    the six that exist) into ``dst_dir/{net}.msgpack``; returns ``{net:
    written path}``.  ``reference_path`` (the reference's source tree) goes
    first on ``sys.path`` for the unpickling."""
    if reference_path and reference_path not in sys.path:
        sys.path.insert(0, reference_path)
    written = {}
    for name in NETWORKS:
        src = os.path.join(src_dir, f"{name}.pth")
        if not os.path.exists(src):
            continue
        ref = _unwrap(torch.load(src, map_location="cpu", weights_only=False))
        written[name] = save_params(os.path.join(dst_dir, f"{name}.msgpack"),
                                    port_network(name, ref))
    return written
