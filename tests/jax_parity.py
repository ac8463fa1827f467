"""Hold a port module to a JAX module on the CPU: forward and every
parameter's gradient from one (jitted) ``value_and_grad`` of the JAX module
on the port's own parameters, carried to the JAX layout by
``utils/weights.jax_params_from_state_dict``, whose tree is checked against
the JAX module's and carried back by ``state_dict_from_jax`` in bits.  Used
by tests/test_torch_library_models.py and tests/test_torch_bie2e.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gan_ffn_tpu_torch.utils.weights import jax_params_from_state_dict, state_dict_from_jax

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol, err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def hold(port, jax_module, args, out_index=0, jax_kwargs=None, seed=99, eager=False):
    """Hold ``port`` (eval mode) to ``jax_module`` on ``args`` (numpy; None
    passes through): the port's parameters in the JAX layout must be the
    JAX module's tree and come back through ``state_dict_from_jax`` in
    bits; every output within the forward limit (an empty ``[]`` slot the
    same in both), and ``sum(out * w)`` (``out`` the ``out_index``-th
    output) and its gradient for every parameter within FWD_TOL and GRAD_TOL.
    ``eager`` runs the JAX module eagerly, ``init`` and apply, where it
    cannot be traced (Attention's ``mlp`` and ``bi_linear`` scores read a
    concrete init bound at every call).  Returns the JAX outputs."""
    port.eval()
    port.zero_grad(set_to_none=True)
    params = jax_params_from_state_dict(port)
    kwargs = jax_kwargs or {}
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    init = jax_module.init if eager else functools.partial(jax.eval_shape, jax_module.init)
    shapes = init(jax.random.PRNGKey(0), *jargs, **kwargs)["params"]
    assert ({k: tuple(np.shape(v)) for k, v in _leaves(params)}
            == {k: tuple(v.shape) for k, v in _leaves(shapes)})
    sd = state_dict_from_jax(params)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(sd[k], v), k

    def loss(p, *a):
        outs = _outputs(jax_module.apply({"params": p}, *a, **kwargs))
        out = outs[out_index]
        w = jnp.asarray(np.random.default_rng(seed).standard_normal(out.shape).astype(np.float32))
        return jnp.sum(out * w), outs

    value_and_grad = jax.value_and_grad(loss, has_aux=True)
    (want_loss, wants), grads = (value_and_grad if eager else jax.jit(value_and_grad))(params, *jargs)
    targs = [None if a is None else torch.from_numpy(np.asarray(a)) for a in args]
    outs = _outputs(port(*targs))
    assert len(outs) == len(wants)
    for i, (got, want) in enumerate(zip(outs, wants)):
        if isinstance(want, list):
            assert got == want == [], i
        else:
            assert tuple(got.shape) == tuple(want.shape), i
            _close(got.detach(), want, FWD_TOL, f"output {i}")
    out = outs[out_index]
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal(tuple(out.shape))
                         .astype(np.float32))
    got_loss = (out * w).sum()
    got_loss.backward()
    _close(got_loss.item(), float(want_loss), FWD_TOL, "loss")
    got_grads = jax_params_from_state_dict(port, {k: p.grad for k, p in port.named_parameters()})
    want_grads = dict(_leaves(grads))
    for k, g in _leaves(got_grads):
        _close(g, want_grads[k], GRAD_TOL, k)
    return wants
