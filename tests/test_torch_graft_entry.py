"""The port's ``graft_entry.py`` against the JAX package's
``__graft_entry__.py``, on the CPU: ``entry()``'s forward from the bridged
JAX parameters (the JAX function run at a small depth, its ``GAN_FFN``
patched in the test), its example inputs in bits, and
``dryrun_multichip(2)`` over two gloo ranks (two processes), every surface within
the JAX dry run's bounds.  The forward is held to atol 1e-4, the port's
``GAN_FFN`` limit (tests/test_torch_models.py)."""

import importlib.util
import inspect
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import gan_ffn_tpu.models as JM
from gan_ffn_tpu_torch import graft_entry as G
from gan_ffn_tpu_torch.utils.weights import gan_ffn_state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
DEPTH = 2
ATOL = 1e-4


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location("__graft_entry__", REPO / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_matches_the_jax_entry(monkeypatch):
    jax_gan_ffn = JM.GAN_FFN
    monkeypatch.setattr(JM, "GAN_FFN",
                        lambda **kw: jax_gan_ffn(**{**kw, "gen_num_layers": DEPTH}))
    jax_fn, (params, *jax_inputs) = _jax_graft_entry().entry()
    want = np.asarray(jax.jit(jax_fn)(params, *jax_inputs))

    fn, (model, *inputs) = G.entry("cpu", gen_num_layers=DEPTH)
    assert not model.training and model.gen_num_layers == DEPTH and model.n_classes == 6
    for got, ref in zip(inputs, jax_inputs):  # a, v, t, valid_len: the JAX draws
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert inputs[0].shape == (112, 32, 100) and int(inputs[3]) == 110
    model.load_state_dict(gan_ffn_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    got = fn(model, *inputs)
    assert got.shape == want.shape == (112, 32, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_entry_defaults_to_the_full_model_on_the_card():
    params = inspect.signature(G.entry).parameters
    assert params["device"].default == "cuda" and params["gen_num_layers"].default == 8
    if not torch.cuda.is_available():  # no CPU fallback
        with pytest.raises((RuntimeError, AssertionError)):
            G.entry()


def test_dryrun_multichip_two_gloo_ranks(capsys):
    report = G.dryrun_multichip(2, "cpu")
    assert report["world"] == 2 and report["backend"] == "gloo"
    for surface in ("classifier", "stage_a", "stage_a_epoch_fused", "seed_sweep", "grid"):
        assert report[surface]["max_param_delta"] <= G.PARAM_TOL, surface
    assert report["bimodel"]["max_param_delta"] <= G.DRNN_PARAM_TOL
    for surface in ("classifier", "bimodel"):
        got, want = report[surface]["loss"], report[surface]["one_process_loss"]
        assert abs(got - want) <= G.LOSS_TOL * max(1.0, abs(want))
    assert report["seed_sweep"]["grid"] == [2, 1] and report["grid"]["grid"] == [1, 2]
    assert sorted(report["seed_sweep"]["losses"]) == ["0", "1"]
    assert "dryrun_multichip(2): gloo ranks" in capsys.readouterr().out


def test_dryrun_multichip_refuses_what_it_cannot_run():
    with pytest.raises(ValueError):
        G.dryrun_multichip(0, "cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="needs 2 cards"):
            G.dryrun_multichip(2)
