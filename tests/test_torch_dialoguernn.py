"""The port's DialogueRNN path (nn/recurrent.py, nn/attention.py,
models/dialogue_rnn.py, GAN_FFN_DialogueRNN, the classifier steps and epoch
loop on it, cli/train_iemocap_dialoguernn.py) against the JAX package, on
the CPU.

Inputs come from numpy with a seed: L = 16, B = 4, dialogues of 13, 9, 4
and 0 utterances (so valid_len 13 < L, n_real 3 < B, and a fully padded
column).  The JAX side runs its XLA paths (conftest sets
``GANFFN_PALLAS=0``), the port's kernels their plain versions.  Forwards
and gradients are held to rtol 1e-4, atol 1e-6 (``TOL``), as
tests/test_torch_train.py holds stage B: the same f32 math, summed in
other orders.  Train-mode dropout is held by distribution, as in
tests/test_torch_dropout.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mapping import gru_cell_params

from gan_ffn_tpu.cli.common import IEMOCAP_LOSS_WEIGHTS
from gan_ffn_tpu.models import GAN_FFN_DialogueRNN as JaxGAN_FFN_DialogueRNN
from gan_ffn_tpu.models import dialogue_rnn as JD
from gan_ffn_tpu.nn import attention as JA
from gan_ffn_tpu.nn.losses import masked_nll_loss as jax_masked_nll_loss
from gan_ffn_tpu.nn.recurrent import GRUCell as JaxGRUCell
from gan_ffn_tpu.ops.config import use_stacked_bidir
from gan_ffn_tpu.train.classifier import init_classifier_state
from gan_ffn_tpu.train.classifier import make_classifier_steps as jax_steps
from gan_ffn_tpu.train.loop import batch_to_arrays
from gan_ffn_tpu.train.loop import run_epoch as jax_run_epoch
from gan_ffn_tpu.train.optim import torch_adam as jax_adam
from gan_ffn_tpu_torch.cli import train_iemocap_dialoguernn as CLI
from gan_ffn_tpu_torch.data.loaders import Batch
from gan_ffn_tpu_torch.models import GAN_FFN_DialogueRNN, dialogue_rnn as TD
from gan_ffn_tpu_torch.nn import attention as TA
from gan_ffn_tpu_torch.nn.recurrent import GRUCell
from gan_ffn_tpu_torch.train.classifier import make_classifier_steps
from gan_ffn_tpu_torch.train.loop import batch_to_tensors, run_epoch
from gan_ffn_tpu_torch.train.optim import torch_adam
from gan_ffn_tpu_torch.utils.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-6)
L, B, P, C = 16, 4, 2, 6
LENGTHS = np.array([13, 9, 4, 0])
# small recurrent widths: D_m, D_g, D_p, D_e, D_h
DIMS = (20, 16, 16, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The DialogueRNN runs thousands of tiny ops per step: one intra-op
    thread is faster for them, and keeps this file from oversubscribing the
    cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _umask(lengths=LENGTHS, length=L):
    return (np.arange(length)[None, :] < lengths[:, None]).astype(np.float32)


def _qmask(rng, umask):
    """One-hot speakers, all-zero at padding (as the loaders give them)."""
    q = np.eye(P, dtype=np.float32)[rng.integers(0, P, umask.shape[::-1])]
    return q * umask.T[:, :, None]


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=what)


def _port_loss(outs, weights):
    return sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights) if o is not None)


def _jax_loss(outs, weights):
    return sum(jnp.sum(o * w) for o, w in zip(outs, weights) if o is not None)


def _check_param_grads(module, jax_grads):
    grads = state_dict_from_jax(jax_grads)
    named = dict(module.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        _close(named[k].grad.numpy(), g.numpy(), k)


def test_gru_cell_forward_and_gradients_match_jax():
    rng = _rng(0)
    cell = GRUCell(12, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    x, h, w = (rng.standard_normal(s).astype(np.float32) for s in ((5, 12), (5, 8), (5, 8)))
    params = gru_cell_params(cell)
    jm = JaxGRUCell(8)

    def loss(p, x, h):
        return jnp.sum(jm.apply({"params": p}, x, h) * w)

    want, (gp, gx, gh) = jax.value_and_grad(loss, argnums=(0, 1, 2))(params, x, h)
    tx, th = (torch.from_numpy(a).requires_grad_() for a in (x, h))
    got = (cell(tx, th) * torch.from_numpy(w)).sum()
    got.backward()
    _close(got.item(), float(want), "loss")
    _close(tx.grad, gx, "dx")
    _close(th.grad, gh, "dh")
    for name, g in gru_cell_params(cell, get=lambda t: t.grad.numpy()).items():
        _close(g, gp[name], name)


def _attention_case(att_type, single):
    rng = _rng(1)
    mem, cand = 12, (12 if att_type in ("dot", "simple") else 10)
    M = rng.standard_normal((L, B, mem)).astype(np.float32)
    x = rng.standard_normal((B, cand) if single else (5, B, cand)).astype(np.float32)
    if att_type == "simple":
        jm = JA.SimpleAttention(mem)
        port = TA.SimpleAttention(mem, device="cpu")
    else:
        jm = JA.MatchingAttention(mem, cand, 7, att_type)
        port = TA.MatchingAttention(mem, cand, 7, att_type, device="cpu")
    return rng, M, x, jm, port


@pytest.mark.parametrize("att_type,single", [("simple", True)] + [
    (t, s) for t in ("dot", "general", "general2", "concat") for s in (True, False)])
def test_attention_matches_jax_with_a_fully_masked_row(att_type, single):
    """Pool, alpha and every gradient, for one query per dialogue and for a
    time axis of queries; column 3 of the mask is all zero (finite, and 0
    for general2)."""
    rng, M, x, jm, port = _attention_case(att_type, single)
    mask = _umask()
    args = (M, x, mask) if att_type != "simple" else (M, None, mask)
    params = jm.init(jax.random.PRNGKey(0), *args).get("params", {})  # dot has none
    port.load_state_dict(state_dict_from_jax(params))
    want = jm.apply({"params": params}, *args)
    weights = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in want]

    def loss(p, M, x):
        return _jax_loss(jm.apply({"params": p}, M, x if att_type != "simple" else None, mask),
                         weights)

    gp, gM, gx = jax.grad(loss, argnums=(0, 1, 2))(params, M, x)
    tM, tx = (torch.from_numpy(a).requires_grad_() for a in (M, x))
    got = port(tM, tx if att_type != "simple" else None, torch.from_numpy(mask))
    for name, g, w in zip(("pool", "alpha"), got, want):
        assert torch.isfinite(g).all()
        _close(g.detach(), w, name)
    if att_type == "general2":
        assert got[1].detach()[..., 3, :, :].abs().max() == 0.0
    _port_loss(got, weights).backward()
    _close(tM.grad, gM, "dM")
    if att_type != "simple":
        _close(tx.grad, gx, "dx")
    _check_param_grads(port, gp)


def test_reverse_padded_matches_jax():
    rng = _rng(2)
    x = rng.standard_normal((L, B, 5)).astype(np.float32)
    umask = _umask()
    got = TD.reverse_padded(torch.from_numpy(x), torch.from_numpy(umask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JD.reverse_padded(jnp.asarray(x), umask)))
    assert not got[:, 3].any() and not got[LENGTHS[1]:, 1].any()
    np.testing.assert_array_equal(got[:LENGTHS[1], 1], x[:LENGTHS[1], 1][::-1])


def _rnn_inputs(seed, dims=DIMS):
    rng = _rng(seed)
    umask = _umask()
    U = rng.standard_normal((L, B, dims[0])).astype(np.float32)
    return rng, U, _qmask(rng, umask), umask


@pytest.mark.parametrize("listener_state", [False, True])
@pytest.mark.parametrize("context", ["simple", "general", "general2"])
def test_dialogue_rnn_matches_jax(context, listener_state):
    """e and alpha (zero beyond the history, 0 at t = 0), and every
    gradient."""
    D_m, D_g, D_p, D_e, _ = DIMS
    rng, U, qmask, _ = _rnn_inputs(3)
    jm = JD.DialogueRNN(D_m, D_g, D_p, D_e, listener_state, context, D_a=7)
    params = jm.init(jax.random.PRNGKey(1), U, qmask)["params"]
    port = TD.DialogueRNN(D_m, D_g, D_p, D_e, listener_state, context, D_a=7, device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    port.eval()
    want = jm.apply({"params": params}, U, qmask)
    weights = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in want]
    gp, gU = jax.grad(lambda p, U: _jax_loss(jm.apply({"params": p}, U, qmask), weights),
                      argnums=(0, 1))(params, U)
    tU = torch.from_numpy(U).requires_grad_()
    got = port(tU, torch.from_numpy(qmask))
    for name, g, w in zip(("e", "alpha"), got, want):
        _close(g.detach(), w, name)
    alpha = got[1].detach()
    assert alpha[0].abs().max() == 0.0
    assert all(alpha[t, :, t:].abs().max() == 0.0 for t in range(L))
    _port_loss(got, weights).backward()
    _close(tU.grad, gU, "dU")
    _check_param_grads(port, gp)


@pytest.fixture(scope="module")
def bimodel():
    """A JAX BiModel (context attention 'general', the CLI's), its params,
    the port's copy in eval mode, and inputs."""
    D_m, D_g, D_p, D_e, D_h = DIMS
    rng, U, qmask, umask = _rnn_inputs(4)
    jm = JD.BiModel(D_m, D_g, D_p, D_e, D_h, n_classes=C, context_attention="general")
    with use_stacked_bidir(False):
        params = jm.init(jax.random.PRNGKey(2), U, qmask, umask)["params"]
    port = TD.BiModel(D_m, D_g, D_p, D_e, D_h, C, context_attention="general", device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    return jm, params, port.eval(), (U, qmask, umask), rng


@pytest.mark.parametrize("stacked", [True, False])
def test_bimodel_matches_both_jax_paths(bimodel, stacked):
    """log_prob, alpha, alpha_f and alpha_b, and every gradient, against the
    JAX stacked-bidirectional scan and its two-scan path."""
    jm, params, port, (U, qmask, umask), rng = bimodel
    with use_stacked_bidir(stacked):
        want = jm.apply({"params": params}, U, qmask, umask)
        weights = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in want]
        gp, gU = jax.grad(
            lambda p, U: _jax_loss(jm.apply({"params": p}, U, qmask, umask), weights),
            argnums=(0, 1))(params, U)
    port.zero_grad(set_to_none=True)
    tU = torch.from_numpy(U).requires_grad_()
    got = port(tU, torch.from_numpy(qmask), torch.from_numpy(umask))
    for name, g, w in zip(("log_prob", "alpha", "alpha_f", "alpha_b"), got, want):
        assert g.shape == tuple(np.shape(w)) and torch.isfinite(g).all()
        _close(g.detach(), w, name)
    _port_loss(got, weights).backward()
    _close(tU.grad, gU, "dU")
    _check_param_grads(port, gp)


def test_bimodel_train_mode_matches_jax_by_distribution(bimodel):
    """Every dropout on (BiModel's defaults: 0.5 in the cells, 0.65 on the
    emotions, 0.5 after linear), fixed weights with ``smax_fc`` scaled by 10
    so the log-probabilities feel the masks: the quartiles of mean(log_prob
    ** 2) over 384 draws agree with the JAX package's within 6% (measured
    0.8-2.6%; three JAX key streams differ by up to 3.9%); cell dropout 0.3
    instead of 0.5 moves the port's by more than 10% (measured 12-26%).  The
    port's 384 draws are one forward of the batch repeated 384 times: the
    masks are drawn per element and no op mixes the batch's columns."""
    jm, params, _, (U, qmask, umask), _ = bimodel
    params = {**params, "smax_fc": {**params["smax_fc"],
                                    "kernel": params["smax_fc"]["kernel"] * 10.0}}
    port = TD.BiModel(*DIMS, C, context_attention="general", device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    n = 384
    jtrain = JD.BiModel(*DIMS, n_classes=C, context_attention="general", deterministic=False)

    def jax_stat(key):
        lp = jtrain.apply({"params": params}, U, qmask, umask, rngs={"dropout": key})[0]
        return (lp ** 2).mean()

    want = np.quantile(np.asarray(jax.jit(jax.vmap(jax_stat))(
        jax.random.split(jax.random.PRNGKey(7), n))), [0.25, 0.5, 0.75])
    inputs = [torch.from_numpy(U).repeat(1, n, 1), torch.from_numpy(qmask).repeat(1, n, 1),
              torch.from_numpy(umask).repeat(n, 1)]

    def port_quartiles():
        torch.manual_seed(8)
        port.train()
        with torch.no_grad():
            lp = port(*inputs)[0].reshape(L, n, B, C)
        return np.quantile((lp ** 2).mean(dim=(0, 2, 3)).numpy(), [0.25, 0.5, 0.75])

    np.testing.assert_allclose(port_quartiles(), want, rtol=0.06)
    for cell in (port.dialog_rnn_f.dialogue_cell, port.dialog_rnn_r.dialogue_cell):
        cell.dropout = 0.3
    assert np.all(np.abs(port_quartiles() / want - 1) > 0.1)


def _batch(seed, length=L, lengths=LENGTHS, vids=("a", "b", "c", "pad")):
    rng = _rng(seed)
    umask = _umask(lengths, length)
    feats = {k: (rng.standard_normal((length, B, d)) * umask.T[:, :, None]).astype(np.float32)
             for k, d in (("text", 100), ("audio", 100), ("visual", 512))}
    label = (rng.integers(0, C, (B, length)) * umask).astype(np.int32)
    return Batch(feats["text"], feats["audio"], _qmask(rng, umask), umask, label, list(vids),
                 feats["visual"], n_real=int((lengths > 0).sum()))


KW = dict(D_m=100, D_g=16, D_p=16, D_e=8, D_h=100, D_a=7, n_classes=C)


@pytest.fixture(scope="module")
def classifier():
    """A 1-layer JAX GAN_FFN_DialogueRNN (small recurrent widths), its
    params and eval apply, and three batches (L 16, 16 and 8)."""
    batches = [_batch(10), _batch(11, lengths=np.array([16, 2, 7, 0])),
               _batch(12, length=8, lengths=np.array([8, 5, 0, 0]), vids=("d", "e", "p", "q"))]
    jm = JaxGAN_FFN_DialogueRNN(**KW, gen_num_layers=1)
    a = batch_to_arrays(batches[0])
    with use_stacked_bidir(False):
        params = jm.init(jax.random.PRNGKey(3), a["audio"], a["visual"], a["text"],
                         a["qmask"], a["umask"])["params"]

    def apply_eval(p, arrays):
        out = jm.apply({"params": p}, arrays["audio"], arrays["visual"], arrays["text"],
                       arrays["qmask"], arrays["umask"], valid_len=arrays["valid_len"])
        return out[0], {"alpha": out[1], "alpha_f": out[2], "alpha_b": out[3]}

    return params, apply_eval, batches


def _port_classifier(params):
    model = GAN_FFN_DialogueRNN(**KW, gen_num_layers=1, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


def test_gan_ffn_dialoguernn_forward_through_the_weight_bridge(classifier):
    params, apply_eval, batches = classifier
    model = _port_classifier(params).eval()
    t = batch_to_tensors(batches[0], "cpu")
    with torch.no_grad():
        got = model(t["audio"], t["visual"], t["text"], t["qmask"], t["umask"],
                    valid_len=t["valid_len"])
    lp, attn = apply_eval(params, batch_to_arrays(batches[0]))
    for g, w in zip(got, (lp, attn["alpha"], attn["alpha_f"], attn["alpha_b"])):
        _close(g, w)


def test_weight_bridge_refuses_a_missing_or_misshapen_key(classifier):
    params = classifier[0]
    model = GAN_FFN_DialogueRNN(**KW, gen_num_layers=1, device="cpu")
    state = state_dict_from_jax(params)
    key = "bi_model.dialog_rnn_r.dialogue_cell.g_cell.weight_hh"
    assert state[key].shape == (3 * KW["D_g"], KW["D_g"])
    with pytest.raises(RuntimeError, match="size mismatch"):
        model.load_state_dict({**state, key: state[key].T})
    del state[key]
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(state)


# Adam's eps raised to 1e-3 in both frameworks, as in tests/test_torch_train.py:
# parameters whose gradient is 0 in exact arithmetic get noise of either sign.
EPS = 1e-3


def test_deterministic_train_step_matches_jax(classifier):
    """The loss and every gradient of the deterministic step (TOL), then the
    params after 2 Adam steps with the decay schedule's lr_scale (atol 1e-6),
    on the two batches of one shape (one JAX compile)."""
    params, apply_eval, batches = classifier
    batches = batches[:2]
    weights = jnp.asarray(IEMOCAP_LOSS_WEIGHTS)

    def jax_loss(p, arrays):
        lp = apply_eval(p, arrays)[0].transpose(1, 0, 2).reshape(-1, C)
        return jax_masked_nll_loss(lp, arrays["label"].reshape(-1), arrays["umask"], weights)

    arrays = [batch_to_arrays(b) for b in batches]
    want_loss, want_grads = jax.value_and_grad(jax_loss)(params, arrays[0])
    model = _port_classifier(params)
    opt = torch_adam(model.parameters(), 1e-3, eps=EPS, weight_decay=1e-5)
    train_step, _ = make_classifier_steps(model, opt, C, torch.from_numpy(IEMOCAP_LOSS_WEIGHTS),
                                          deterministic=True)
    loss, _ = train_step(batch_to_tensors(batches[0], "cpu"))
    _close(loss.item(), float(want_loss), "loss")
    _check_param_grads(model, want_grads)

    jadam = jax_adam(1e-3, eps=EPS, weight_decay=1e-5)
    jtrain, _ = jax_steps(lambda p, rng, b: apply_eval(p, b)[0], apply_eval, jadam, C, weights)
    state = init_classifier_state(jax.tree.map(jnp.copy, params), jadam)
    state, _, _ = jtrain(state, jax.random.PRNGKey(0), arrays[0], 1.0)
    for e, (batch, arr) in enumerate(zip(batches[1:], arrays[1:]), start=1):
        train_step(batch_to_tensors(batch, "cpu"), 0.98**e)
        state, _, _ = jtrain(state, jax.random.PRNGKey(e), arr, 0.98**e)
    want = state_dict_from_jax(jax.tree.map(np.asarray, state["params"]))
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_eval_epoch_attentions_match_jax(classifier):
    """EpochResult.attentions: per batch, each alpha cut to the batch's
    n_real columns (TOL), and the vids; the loss and predictions too."""
    params, apply_eval, batches = classifier
    _, jeval = jax_steps(lambda p, rng, b: apply_eval(p, b)[0], apply_eval, jax_adam(1e-3), C,
                         jnp.asarray(IEMOCAP_LOSS_WEIGHTS), eval_attentions=True)
    want = jax_run_epoch(batches, params, eval_step=jeval, eval_attentions=True)
    model = _port_classifier(params)
    _, eval_step = make_classifier_steps(model, torch_adam(model.parameters(), 1e-3), C,
                                         torch.from_numpy(IEMOCAP_LOSS_WEIGHTS))
    got = run_epoch(batches, eval_step, "cpu")
    np.testing.assert_allclose(got.avg_loss, want.avg_loss, rtol=1e-5)
    np.testing.assert_array_equal(got.preds, want.preds)
    assert set(got.attentions) == set(want.attentions) == {"alpha", "alpha_f", "alpha_b", "vids"}
    assert got.attentions["vids"] == want.attentions["vids"] == [list(b.vids) for b in batches]
    for key in ("alpha", "alpha_f", "alpha_b"):
        assert [a.shape for a in got.attentions[key]] == [
            (b.seq_len, b.n_real, b.seq_len) for b in batches]
        for g, w in zip(got.attentions[key], want.attentions[key]):
            _close(g, w, key)
    train_step, _ = make_classifier_steps(model, torch_adam(model.parameters(), 1e-3), C)
    assert run_epoch(batches[:1], train_step, "cpu").attentions is None


def _cli(cwd, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "gan_ffn_tpu_torch.cli.train_iemocap_dialoguernn", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


@pytest.fixture(scope="module")
def short_dialogues(tmp_path_factory):
    """A synthetic fixture of 16 + 6 dialogues of 4-24 utterances (the 32
    bucket)."""
    from gan_ffn_tpu_torch.data import write_synthetic_iemocap

    path = tmp_path_factory.mktemp("short") / "IEMOCAP_features.pkl"
    return write_synthetic_iemocap(str(path), n_train=16, n_test=6, min_len=4, max_len=24,
                                   seed=2)


def test_cli_trains_on_the_cpu(tmp_path, short_dialogues):
    """Stage A (0 epochs: the six networks saved as drawn), the graft and 2
    stage-B epochs at depth 1; then a second run loads the six saved
    networks instead of training them."""
    common = ["--data-path", short_dialogues, "--epochs", "2", "--num-layers", "1",
              "--device", "cpu", "--batch-size", "8"]
    res = _cli(tmp_path, *common, "--fresh-GAN", "--GAN-epochs", "0")
    assert res.returncode == 0, res.stderr
    epochs = [l for l in res.stdout.splitlines() if l.startswith("epoch ")]
    assert len(epochs) == 2 and all("test_loss" in l and "utt/s" in l for l in epochs)
    assert "finished training GAN" in res.stdout and "F1-score" in res.stdout
    assert (tmp_path / "output" / "GAN_loss.csv").is_file()
    for name in ("acoustic", "visual", "text"):
        for kind in ("gen", "disc"):
            assert (tmp_path / "GAN_save" / f"{name}_{kind}.pt").is_file()
            assert (tmp_path / "GAN_save" / "opt" / f"{name}_{kind}.pt").is_file()
    state = torch.load(tmp_path / "GAN_save" / "dialoguernn_classifier_best.pt",
                       weights_only=True)
    assert set(state) == set(GAN_FFN_DialogueRNN(gen_num_layers=1, device="cpu").state_dict())
    again = _cli(tmp_path, *common, "--epochs", "1")
    assert again.returncode == 0, again.stderr
    assert "loaded trained GAN" in again.stdout and "finished training GAN" not in again.stdout


def test_cli_main_returns_the_best_epoch(tmp_path, monkeypatch, short_dialogues):
    monkeypatch.chdir(tmp_path)
    res = CLI.main(["--data-path", short_dialogues, "--fresh-GAN", "--GAN-epochs", "0",
                    "--epochs", "1", "--num-layers", "1", "--device", "cpu", "--batch-size", "4",
                    "--attention", "general2", "--active-listener"])
    assert set(res) == {"best_loss", "f1", "attentions"}
    assert np.isfinite(res["best_loss"]) and 0.0 <= res["f1"] <= 100.0
    attn = res["attentions"]
    assert sum(len(v) for v in attn["vids"]) == 6 and len(attn["vids"]) == 2
    for key in ("alpha", "alpha_f", "alpha_b"):
        assert [a.shape[1] for a in attn[key]] == [len(v) for v in attn["vids"]]


@pytest.mark.parametrize("flags,item", [
    (["--bf16"], "Queue 1 item 4"),
    (["--dp"], "module note 13"),
    (["--scan-layers"], "module note 15"),
    (["--tensorboard"], "module note 15"),
])
def test_cli_refuses_what_later_slices_bring(flags, item, capsys):
    with pytest.raises(SystemExit) as exc:
        CLI.main(["--device", "cpu", *flags])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


def test_cli_defaults_to_the_card_and_does_not_fall_back(capsys):
    args = CLI.build_parser().parse_args([])
    assert (args.device, args.batch_size, args.epochs, args.l2, args.rec_dropout, args.dropout,
            args.attention, args.use_trained_GAN) == ("cuda", 30, 100, 1e-5, 0.1, 0.6,
                                                      "general", True)
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as exc:
        CLI.main([])
    assert exc.value.code == 2
    assert "no CUDA card" in capsys.readouterr().err


@pytest.mark.slow
def test_full_pipeline_f1_band(tmp_path, monkeypatch):
    """The band of tests/test_train.py::test_dialoguernn_pipeline_f1_band
    (F1 24.0-36.5, best loss 1.36-1.51) from the port's own init: the same
    fixture (120 + 31 dialogues, lengths 6-24, label noise 0.25, seed 3407),
    depth-1 encoders, 2 stage-A epochs, 60 stage-B epochs at lr 3e-4."""
    from gan_ffn_tpu_torch.data import write_synthetic_iemocap

    fixture = str(tmp_path / "IEMOCAP_features.pkl")
    write_synthetic_iemocap(fixture, n_train=120, n_test=31, min_len=6, max_len=24,
                            class_spread=2.0, label_noise=0.25, seed=3407)
    monkeypatch.chdir(tmp_path)
    res = CLI.main(["--data-path", fixture, "--epochs", "60", "--GAN-epochs", "2",
                    "--num-layers", "1", "--fresh-GAN", "--lr", "0.0003", "--device", "cpu"])
    assert 24.0 <= res["f1"] <= 36.5, res
    assert 1.36 <= float(res["best_loss"]) <= 1.51, res
