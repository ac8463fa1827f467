"""Checkpoints in the JAX package's format (counterpart of
``gan_ffn_tpu/utils/checkpoint.py``; reference train_IEMOCAP.py:427-438,
527-570), so that a directory written by either package serves the
other's entry points.

Each file is the msgpack of a JAX params tree, as
``flax.serialization.to_bytes`` writes it (``utils/msgpack.py``; no
``flax`` or ``msgpack`` package is needed), one per network, with the JAX
package's names:

    {save_dir}/acoustic_gen.msgpack, {save_dir}/acoustic_disc.msgpack, ...
    {save_dir}/opt/acoustic_gen.msgpack, ...
    {save_dir}/classifier_best.msgpack             (cli/train_iemocap)
    {save_dir}/dialoguernn_classifier_best.msgpack (cli/train_iemocap_dialoguernn)
    {save_dir}/meld_classifier_best.msgpack        (cli/train_meld)

A port module's ``state_dict`` maps to and from the JAX tree through
``utils/weights.py``.  A stage-A network's torch Adam (weight decay 0)
maps to the optax chain state the JAX package saves for its
``torch_adam``, ``{"0": {"count", "mu", "nu"}, "1": {}}``: ``step`` <->
``count`` (int32), ``exp_avg`` <-> ``mu`` and ``exp_avg_sq`` <-> ``nu``,
through the weight rewrites.

Files are written in the unrolled layout (``layers_i``), or with
``scan_layers`` (``--scan-layers``) in the stacked one (one ``layers``
subtree), as the JAX trainers write under that flag; every reader here
accepts either (:func:`load_params_any_layout`).  Loading is strict
(``load_state_dict``), onto the modules' own device.  ``reset_opt=True``
keeps the fresh Adams, as the reference does on resume (it re-creates the
six Adams inside train_GAN).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from ..train.gan import DISC_NAMES, GEN_NAMES, GANState
from . import msgpack
from .weights import (jax_params_from_state_dict, stack_layer_params, state_dict_from_jax,
                      tree_leaves)

GAN_NET_NAMES = GEN_NAMES + DISC_NAMES


def save_params(path: str, params: Union[nn.Module, Mapping[str, Any]],
                scan_layers: bool = False) -> str:
    """Write ``params`` (a JAX params tree, or a port module, whose
    parameters are written as the JAX tree of the same module) to ``path``;
    with ``scan_layers`` the encoders' layers stacked.  Returns ``path``."""
    if isinstance(params, nn.Module):
        params = jax_params_from_state_dict(params)
    if scan_layers:
        params = stack_layer_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.to_bytes(params))
    return path


def load_params(path: str) -> Any:
    """The tree that ``path`` holds, in its own layout (numpy leaves)."""
    with open(path, "rb") as f:
        return msgpack.from_bytes(f.read())


def all_float32(path: str) -> bool:
    """Whether the params file ``path`` holds leaves and every one is a
    float32 array: what a ``--bf16`` trainer writes, whose parameters stay
    float32 (each leaf is written in its parameter's dtype)."""
    leaves = list(tree_leaves(load_params(path)))
    return bool(leaves) and all(isinstance(v, np.ndarray) and v.dtype == np.float32
                                for v in leaves)


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The params file ``path`` (either layout) as a port ``state_dict`` of
    float32 CPU tensors."""
    return state_dict_from_jax(load_params(path))


def load_params_any_layout(path: str, module: nn.Module) -> nn.Module:
    """Load the params file ``path``, written in either encoder layout (the
    JAX export and predict CLIs' reader of ``--scan-layers`` checkpoints),
    into ``module`` (strict, onto its device); returns ``module``."""
    module.load_state_dict(read_state_dict(path), strict=True)
    return module


def _check_no_decay(opt: torch.optim.Adam) -> None:
    """Stage A's Adams have no weight decay; with one, the JAX chain would
    lead with ``add_decayed_weights``' state, which is not mapped here."""
    if any(group["weight_decay"] for group in opt.param_groups):
        raise ValueError("only an Adam without weight decay maps to the JAX stage-A state")


def adam_state_to_jax(opt: torch.optim.Adam, module: nn.Module) -> Dict[str, Any]:
    """``opt`` (an Adam over ``module``'s parameters) as the optax chain
    state of the JAX ``torch_adam``: one int32 ``count``, ``mu`` and ``nu``
    as params trees of ``module`` (zeros and count 0 before the first step)."""
    _check_no_decay(opt)
    params = dict(module.named_parameters())
    states = [opt.state.get(p, {}) for p in params.values()]
    steps = {float(s["step"]) for s in states if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"the Adam's parameters have different step counts {sorted(steps)}: "
                         "the JAX state holds one count")
    moments = {}
    for key, jax_key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        moments[jax_key] = jax_params_from_state_dict(
            module, {n: s[key] if key in s else torch.zeros_like(params[n])
                     for n, s in zip(params, states)})
    count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
    return {"0": {"count": count, **moments}, "1": {}}


def load_adam_state_from_jax(opt: torch.optim.Adam, module: nn.Module,
                             tree: Mapping[str, Any]) -> None:
    """Set ``opt``'s state (an Adam over ``module``'s parameters) from the
    optax chain state ``tree`` of :func:`adam_state_to_jax`, either
    layout: every parameter's ``step``, ``exp_avg`` and ``exp_avg_sq``."""
    _check_no_decay(opt)
    try:
        count, mu, nu = (tree["0"][k] for k in ("count", "mu", "nu"))
    except (KeyError, TypeError):
        raise ValueError("not the optax state of the JAX torch_adam") from None
    mu, nu = state_dict_from_jax(mu), state_dict_from_jax(nu)
    names = {id(p): n for n, p in module.named_parameters()}
    if set(mu) != set(names.values()) or set(nu) != set(names.values()):
        raise ValueError(f"the Adam state's moments and the {type(module).__name__}'s "
                         "parameters differ")
    step = float(np.asarray(count))
    for group in opt.param_groups:
        on_device = group.get("capturable", False) or group.get("fused", False)
        for p in group["params"]:
            name = names[id(p)]
            opt.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32,
                                     device=p.device if on_device else "cpu"),
                "exp_avg": mu[name].to(p.device, p.dtype),
                "exp_avg_sq": nu[name].to(p.device, p.dtype),
            }


def _paths(save_dir: str, name: str):
    return (os.path.join(save_dir, f"{name}.msgpack"),
            os.path.join(save_dir, "opt", f"{name}.msgpack"))


def save_gan_state(save_dir: str, state: GANState, scan_layers: bool = False) -> None:
    """Write all six networks' weights and Adam states under ``save_dir``
    (with ``scan_layers`` in the stacked layout)."""
    for name in GAN_NET_NAMES:
        weights, opt = _paths(save_dir, name)
        save_params(weights, state.modules[name], scan_layers)
        save_params(opt, adam_state_to_jax(state.opts[name], state.modules[name]), scan_layers)


def load_gan_state(save_dir: str, modules: Dict[str, nn.Module],
                   opts: Dict[str, torch.optim.Adam], reset_opt: bool = False) -> GANState:
    """Load what :func:`save_gan_state` (or the JAX package's) wrote, in
    either layout, into ``modules`` and, unless ``reset_opt`` or where a
    network has no ``opt/`` file (as the JAX loader does), ``opts`` (in
    place); returns them as a :class:`GANState`."""
    for name in GAN_NET_NAMES:
        weights, opt = _paths(save_dir, name)
        load_params_any_layout(weights, modules[name])
        if not reset_opt and os.path.exists(opt):
            load_adam_state_from_jax(opts[name], modules[name], load_params(opt))
    return GANState(modules, opts)
