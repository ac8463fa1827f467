"""Weight bridge between JAX params and the port's ``state_dict``s, both
ways, for every model of the port: ``GAN_FFN``, ``GAN_FFN_DialogueRNN``,
the six networks of stage A, ``BiModel`` and ``BiE2EModel``, and the
baselines (``MELDLSTMModel`` and the library-only eight).

A JAX tree (nested dicts of arrays) maps onto the port's module tree name
for name, with these rewrites:

- TorchLinear ``kernel (in, out)`` -> ``weight (out, in)`` (the attentions'
  ``transform``, ``scalar`` and ``vector_prod`` among them);
- ``in_proj_kernel (E, 3E)`` -> ``in_proj_weight (3E, E)``;
- GRU ``w_ih (D_in, 3H)`` -> ``weight_ih (3H, D_in)``, ``w_hh`` ->
  ``weight_hh``, ``b_ih`` / ``b_hh`` -> ``bias_ih`` / ``bias_hh``, and so
  the LSTM's per-layer ``w_ih_l{k}[_reverse] (in, 4H)`` -> ``weight_ih_l{k}
  [_reverse] (4H, in)``, ``b_ih_l{k}[_reverse]`` -> ``bias_ih_l{k}[_reverse]``;
- LayerNorm ``scale`` -> ``weight`` (and RMSNorm's);
- flax ``Conv`` ``kernel``: 2-D ``(fs, E, 1, F)`` -> ``Conv2d`` ``weight (F,
  1, fs, E)``, 1-D ``(K, E, F)`` -> ``Conv1d`` ``weight (F, E, K)``;
- flax ``Embed`` ``embedding (V, D)`` -> ``weight (V, D)``;
- ``layers_i`` -> ``layers.i``.

The Moonlight text generator's own leaves (``models/moonlight.py``: a
router's ``kernel`` and ``e_score_correction_bias``, the experts' stacked
``w_gate``, ``w_up``, ``w_down``) keep torch's layout: the JAX package has
no such module.

``load_state_dict`` (strict, the default) then refuses missing, extra and
misshapen keys.

A checkpoint written under ``--scan-layers`` (one ``layers`` subtree whose
leaves carry a stacked leading axis) is unstacked first, with a numpy copy
of ``gan_ffn_tpu.nn.transformer.unstack_layer_params``.

:func:`jax_params_from_state_dict` is the inverse: a port module's
``state_dict`` becomes the JAX tree of the same module (each leaf in its
parameter's dtype), each rewrite above undone.  Which JAX name a
``weight`` takes (``kernel``, transposed, or ``scale``) is decided by the
type of the module that owns it (:func:`parameter_layout`), and a ``ModuleList`` child ``i``
of ``layers`` becomes ``layers_i``; with ``scan_layers`` the encoders'
layers are stacked into one ``layers`` subtree (:func:`stack_layer_params`,
a numpy copy of ``gan_ffn_tpu.nn.transformer.stack_layer_params``), the
layout the JAX trainers write under ``--scan-layers``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.attention import Attention
from ..nn.core import Embedding, LayerNorm, Linear, RMSNorm
from ..nn.moe import Experts, Router
from ..nn.recurrent import GRU, LSTM, GRUCell, LSTMCell
from ..nn.transformer import MultiheadSelfAttention
from ..train.gan import DISC_NAMES, GEN_NAMES

_LAYER = re.compile(r"layers_(\d+)")
_TRANSPOSED = {"kernel": "weight", "in_proj_kernel": "in_proj_weight",
               "w_ih": "weight_ih", "w_hh": "weight_hh"}
_RENAMED = {"scale": "weight", "b_ih": "bias_ih", "b_hh": "bias_hh", "embedding": "weight"}
_LSTM_LAYER = re.compile(r"(w_ih|w_hh|b_ih|b_hh)(_l\d+(?:_reverse)?)")  # an LSTM's per-layer name


def _is_scanned_encoder(node) -> bool:
    return (
        isinstance(node, Mapping)
        and isinstance(node.get("layers"), Mapping)
        and "self_attn" in node["layers"]
    )


def tree_leaves(node):
    """The leaves of a tree of maps, in insertion order."""
    if isinstance(node, Mapping):
        for v in node.values():
            yield from tree_leaves(v)
    else:
        yield node


def _map_leaves(fn, node):
    if isinstance(node, Mapping):
        return {k: _map_leaves(fn, v) for k, v in node.items()}
    return fn(node)


def _is_unrolled_encoder(node) -> bool:
    return isinstance(node, Mapping) and "layers_0" in node


def _stack(trees):
    """The leaves of ``trees`` (one structure) stacked on a new leading axis."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees)
    return np.stack([np.asarray(t) for t in trees])


def stack_layer_params(params):
    """Stack every unrolled-encoder subtree (``layers_0`` ..
    ``layers_{n-1}``) into one ``layers`` subtree whose leaves carry a new
    leading axis, the other keys first (as the JAX function orders them)."""
    if not isinstance(params, Mapping):
        return params
    if _is_unrolled_encoder(params):
        n = sum(1 for k in params if _LAYER.fullmatch(k))
        out = {k: stack_layer_params(v) for k, v in params.items() if not _LAYER.fullmatch(k)}
        out["layers"] = _stack([params[f"layers_{i}"] for i in range(n)])
        return out
    return {k: stack_layer_params(v) for k, v in params.items()}


def unstack_layer_params(params):
    """Split every scanned-encoder ``layers`` subtree into ``layers_i``."""
    if not isinstance(params, Mapping):
        return params
    if _is_scanned_encoder(params):
        stacked = params["layers"]
        n = np.shape(next(tree_leaves(stacked)))[0]
        out = {k: unstack_layer_params(v) for k, v in params.items() if k != "layers"}
        for i in range(n):
            out[f"layers_{i}"] = _map_leaves(
                lambda x, i=i: x[i] if isinstance(x, torch.Tensor) else np.asarray(x)[i], stacked)
        return out
    return {k: unstack_layer_params(v) for k, v in params.items()}


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Any JAX module's params (nested dicts of arrays, unrolled or scanned
    layout) -> the ``state_dict`` of the port's module of the same tree
    (float32 CPU tensors; ``bfloat16`` leaves, which the msgpack reader
    gives as tensors, widened exactly)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                m = _LAYER.fullmatch(key)
                walk(value, path + (["layers", m.group(1)] if m else [key]))
                continue
            arr = (value.float().numpy() if isinstance(value, torch.Tensor)
                   else np.asarray(value, dtype=np.float32))
            m = _LSTM_LAYER.fullmatch(key)
            base, suffix = m.groups() if m else (key, "")
            if base in _TRANSPOSED:
                # a 2-D conv's (fs, E, 1, F) -> (F, 1, fs, E); every other rank reversed
                key = _TRANSPOSED[base] + suffix
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
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


# the parameters a module type owns itself: port name -> (JAX name, transposed)
_OWNED = {
    Linear: {"weight": ("kernel", True), "bias": ("bias", False)},
    LayerNorm: {"weight": ("scale", False), "bias": ("bias", False)},
    MultiheadSelfAttention: {"in_proj_weight": ("in_proj_kernel", True),
                             "in_proj_bias": ("in_proj_bias", False)},
    nn.Conv1d: {"weight": ("kernel", True), "bias": ("bias", False)},
    nn.Conv2d: {"weight": ("kernel", True), "bias": ("bias", False)},
    Embedding: {"weight": ("embedding", False)},
    Attention: {"weight": ("weight", False)},  # the mlp and bi_linear scores' own
    RMSNorm: {"weight": ("scale", False)},
    Router: {"weight": ("kernel", True),
             "e_score_correction_bias": ("e_score_correction_bias", False)},
    Experts: {"w_gate": ("w_gate", False), "w_up": ("w_up", False), "w_down": ("w_down", False)},
}
_RECURRENT = (GRUCell, GRU, LSTMCell, LSTM)
_RECURRENT_NAME = re.compile(r"(weight|bias)_(ih|hh)(_l\d+(?:_reverse)?)?")


def _jax_leaf(owner: nn.Module, name: str) -> Tuple[str, bool]:
    """The JAX name of ``owner``'s own parameter ``name``, and whether its
    matrix is transposed between the two layouts."""
    for cls, names in _OWNED.items():
        if type(owner) is cls and name in names:
            return names[name]
    m = _RECURRENT_NAME.fullmatch(name)
    if isinstance(owner, _RECURRENT) and m:
        kind, gate, suffix = m.groups()
        return ("w_" if kind == "weight" else "b_") + gate + (suffix or ""), kind == "weight"
    raise ValueError(f"no JAX name for the parameter {name!r} of a {type(owner).__name__}")


def parameter_layout(module: nn.Module) -> List[Tuple[str, Tuple[str, ...], bool]]:
    """``(state_dict key, JAX path, transposed)`` for every parameter of
    ``module``, in ``named_parameters`` order: the path is the module path
    with each ``ModuleList`` child ``i`` of ``name`` as ``name_i``, then the
    JAX leaf name of the owning module's type."""
    out = []
    for prefix, owner in module.named_modules():
        path: List[str] = []
        parent = module
        for part in prefix.split(".") if prefix else []:
            child = parent._modules[part]
            if isinstance(parent, nn.ModuleList):
                path[-1] = f"{path[-1]}_{part}"
            else:
                path.append(part)
            parent = child
        for name, p in owner._parameters.items():
            if p is None:
                continue
            leaf, transposed = _jax_leaf(owner, name)
            out.append((f"{prefix}.{name}" if prefix else name, tuple(path) + (leaf,), transposed))
    return out


def jax_params_from_state_dict(module: nn.Module,
                               state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                               scan_layers: bool = False) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax`: ``state_dict`` (default:
    ``module``'s own) as the JAX params tree of the same module, in the JAX
    layout (``kernel (in, out)`` and so on); with ``scan_layers`` the
    encoders' layers stacked.  Each leaf keeps its tensor's dtype, as
    ``flax.serialization`` writes each leaf in its own: a numpy array, or
    a CPU tensor where numpy has no such dtype (``bfloat16``, which
    ``utils/msgpack`` writes as flax does).  The ``state_dict`` must hold
    exactly ``module``'s parameters."""
    if state_dict is None:
        state_dict = module.state_dict()
    layout = parameter_layout(module)
    missing = {key for key, _, _ in layout} ^ set(state_dict)
    if missing:
        raise ValueError(f"the state_dict and the {type(module).__name__}'s parameters differ "
                         f"in {sorted(missing)[:8]}")
    tree: Dict[str, Any] = {}
    for key, path, transposed in layout:
        t = state_dict[key].detach().to("cpu")
        if transposed:  # a Conv2d's (F, 1, fs, E) -> (fs, E, 1, F); every other rank reversed
            t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.permute(*reversed(range(t.dim())))
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        # copies: the tree never shares memory with the module
        node[path[-1]] = (t.contiguous().clone() if t.dtype == torch.bfloat16
                          else np.array(t.numpy(), order="C"))
    return stack_layer_params(tree) if scan_layers else tree
