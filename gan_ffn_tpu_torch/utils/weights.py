"""Weight bridge: JAX params -> the port's ``state_dict``s, for ``GAN_FFN``,
``GAN_FFN_DialogueRNN``, ``MELDLSTMModel`` and the six networks of stage A.

A JAX tree (nested dicts of arrays) maps onto the port's module tree name
for name, with these rewrites:

- TorchLinear ``kernel (in, out)`` -> ``weight (out, in)`` (the attentions'
  ``transform``, ``scalar`` and ``vector_prod`` among them);
- ``in_proj_kernel (E, 3E)`` -> ``in_proj_weight (3E, E)``;
- GRU ``w_ih (D_in, 3H)`` -> ``weight_ih (3H, D_in)``, ``w_hh`` ->
  ``weight_hh``, ``b_ih`` / ``b_hh`` -> ``bias_ih`` / ``bias_hh``, and so
  the LSTM's per-layer ``w_ih_l{k}[_reverse] (in, 4H)`` -> ``weight_ih_l{k}
  [_reverse] (4H, in)``, ``b_ih_l{k}[_reverse]`` -> ``bias_ih_l{k}[_reverse]``;
- LayerNorm ``scale`` -> ``weight``;
- ``layers_i`` -> ``layers.i``.

``load_state_dict`` (strict, the default) then refuses missing, extra and
misshapen keys.

A checkpoint written under ``--scan-layers`` (one ``layers`` subtree whose
leaves carry a stacked leading axis) is unstacked first, with a numpy copy
of ``gan_ffn_tpu.nn.transformer.unstack_layer_params``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..train.gan import DISC_NAMES, GEN_NAMES

_LAYER = re.compile(r"layers_(\d+)")
_TRANSPOSED = {"kernel": "weight", "in_proj_kernel": "in_proj_weight",
               "w_ih": "weight_ih", "w_hh": "weight_hh"}
_RENAMED = {"scale": "weight", "b_ih": "bias_ih", "b_hh": "bias_hh"}
_LSTM_LAYER = re.compile(r"(w_ih|w_hh|b_ih|b_hh)(_l\d+(?:_reverse)?)")  # an LSTM's per-layer name


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


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Any JAX module's params (nested dicts of arrays, unrolled or scanned
    layout) -> the ``state_dict`` of the port's module of the same tree
    (float32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                m = _LAYER.fullmatch(key)
                walk(value, path + (["layers", m.group(1)] if m else [key]))
                continue
            arr = np.asarray(value, dtype=np.float32)
            m = _LSTM_LAYER.fullmatch(key)
            base, suffix = m.groups() if m else (key, "")
            if base in _TRANSPOSED:
                key, arr = _TRANSPOSED[base] + suffix, arr.T
            else:
                key = _RENAMED.get(base, base) + suffix
            out[".".join(path + [key])] = torch.tensor(arr)  # a contiguous copy

    walk(unstack_layer_params(params), [])
    return out


def gan_ffn_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``GAN_FFN`` params -> the port's ``GAN_FFN`` ``state_dict``."""
    return state_dict_from_jax(params)


def meld_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``MELDLSTMModel`` params -> the port's ``MELDLSTMModel``
    ``state_dict`` (the LSTM's ``w_ih_l0`` -> ``weight_ih_l0`` transposed,
    and so on)."""
    return state_dict_from_jax(params)


def gan_state_dicts_from_jax(gan_params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX GAN state's ``params`` (``init_gan_state(...)["params"]``:
    one tree for each of the six networks) -> ``{name: state_dict}`` for the
    port's six modules of ``train.gan.create_gan_modules``, the visual
    discriminator's ``object`` included."""
    return {name: state_dict_from_jax(gan_params[name]) for name in GEN_NAMES + DISC_NAMES}
