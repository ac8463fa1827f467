"""Weight bridge: JAX ``GAN_FFN`` params -> the port's ``state_dict``.

The JAX tree (nested dicts of arrays) maps onto the port's module tree name
for name, with four rewrites:

- TorchLinear ``kernel (in, out)`` -> ``weight (out, in)``;
- ``in_proj_kernel (E, 3E)`` -> ``in_proj_weight (3E, E)``;
- LayerNorm ``scale`` -> ``weight``;
- ``layers_i`` -> ``layers.i``.

A checkpoint written under ``--scan-layers`` (one ``layers`` subtree whose
leaves carry a stacked leading axis) is unstacked first, with a numpy copy
of ``gan_ffn_tpu.nn.transformer.unstack_layer_params``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"layers_(\d+)")
_TRANSPOSED = {"kernel": "weight", "in_proj_kernel": "in_proj_weight"}


def _is_scanned_encoder(node) -> bool:
    return (
        isinstance(node, Mapping)
        and isinstance(node.get("layers"), Mapping)
        and "self_attn" in node["layers"]
    )


def _leaves(node):
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def _map_leaves(fn, node):
    if isinstance(node, Mapping):
        return {k: _map_leaves(fn, v) for k, v in node.items()}
    return fn(node)


def unstack_layer_params(params):
    """Split every scanned-encoder ``layers`` subtree into ``layers_i``."""
    if not isinstance(params, Mapping):
        return params
    if _is_scanned_encoder(params):
        stacked = params["layers"]
        n = np.shape(next(_leaves(stacked)))[0]
        out = {k: unstack_layer_params(v) for k, v in params.items() if k != "layers"}
        for i in range(n):
            out[f"layers_{i}"] = _map_leaves(lambda x, i=i: np.asarray(x)[i], stacked)
        return out
    return {k: unstack_layer_params(v) for k, v in params.items()}


def gan_ffn_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``GAN_FFN`` params (nested dicts of arrays, unrolled or scanned
    layout) -> the port's ``GAN_FFN`` ``state_dict`` (float32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                m = _LAYER.fullmatch(key)
                walk(value, path + (["layers", m.group(1)] if m else [key]))
                continue
            arr = np.asarray(value, dtype=np.float32)
            if key in _TRANSPOSED:
                key, arr = _TRANSPOSED[key], arr.T
            elif key == "scale":
                key = "weight"
            out[".".join(path + [key])] = torch.tensor(arr)  # a contiguous copy

    walk(unstack_layer_params(params), [])
    return out
