"""The port's MELD path (nn/core.hardswish, nn/recurrent.LSTMCell and LSTM,
models/baselines.MELDLSTMModel, the MELD data, the classifier steps on the
model and cli/train_meld.py) against the JAX package, on the CPU.

Inputs come from numpy with a seed.  Forwards are held to atol 1e-5 and
gradients to atol 1e-4 (rtol 1e-4): the same f32 math, summed in other
orders.  At bf16 the port rounds where the JAX modules do, so the model is
held to 1e-2 (``BF16_TOL``, the bf16 tests' model limit).  Train-mode
dropout is held by distribution.  The file runs torch on one intra-op
thread.
"""

import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mapping import lstm_params

from gan_ffn_tpu.data import get_meld_loaders as jax_get_meld_loaders
from gan_ffn_tpu.data import write_synthetic_meld as jax_write_synthetic_meld
from gan_ffn_tpu.models import MELDLSTMModel as JaxMELDLSTMModel
from gan_ffn_tpu.nn.core import hardswish as jax_hardswish
from gan_ffn_tpu.nn.recurrent import LSTM as JaxLSTM
from gan_ffn_tpu.nn.recurrent import LSTMCell as JaxLSTMCell
from gan_ffn_tpu.train.classifier import init_classifier_state
from gan_ffn_tpu.train.classifier import make_classifier_steps as jax_steps
from gan_ffn_tpu.train.loop import batch_to_arrays
from gan_ffn_tpu.train.optim import torch_adam as jax_adam
from gan_ffn_tpu_torch.cli import train_meld as CLI
from gan_ffn_tpu_torch.data import get_meld_loaders, write_synthetic_meld
from gan_ffn_tpu_torch.models import MELDLSTMModel
from gan_ffn_tpu_torch.nn import recurrent as R
from gan_ffn_tpu_torch.nn.core import hardswish
from gan_ffn_tpu_torch.train.classifier import make_classifier_steps
from gan_ffn_tpu_torch.train.loop import batch_to_tensors
from gan_ffn_tpu_torch.train.optim import torch_adam
from gan_ffn_tpu_torch.utils.checkpoint import all_float32, read_state_dict
from gan_ffn_tpu_torch.utils.weights import meld_state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 1e-2
L, B, C = 12, 4, 7
LENGTHS = np.array([12, 7, 3, 0])  # a padded tail and a fully padded column
SMALL = dict(D_m=24, D_e=8, D_h=16)
PUBLISHED = dict(D_m=600, D_e=300, D_h=600)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The LSTM's loop over time runs many small ops: one intra-op thread
    keeps this file from oversubscribing the cores that parallel test
    workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol, err_msg=what)


def _umask(lengths=LENGTHS, length=L):
    return (np.arange(length)[None, :] < lengths[:, None]).astype(np.float32)


def _meld_inputs(seed, D_m, length=L, lengths=LENGTHS):
    """Text features zero at padding, one-hot 9-party speakers, the umask."""
    rng = np.random.default_rng(seed)
    um = _umask(lengths, length)
    U = rng.standard_normal((length, len(lengths), D_m)).astype(np.float32) * um.T[:, :, None]
    qm = np.eye(9, dtype=np.float32)[rng.integers(0, 9, um.shape[::-1])] * um.T[:, :, None]
    return U, qm, um


# (a) hardswish


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hardswish_gives_the_jax_bits(dtype):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096) * 4,
                        np.array([-3.0, -2.999, 3.0, 2.999, 0.0, -0.0, 1e-3, -6.0, 6.0])])
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jax_hardswish(jx).astype(jnp.float32))
    tx = torch.tensor(x, dtype=getattr(torch, dtype))
    got = hardswish(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))


# (b) LSTMCell and LSTM


def test_lstm_cell_forward_and_gradients_match_jax():
    rng = np.random.default_rng(1)
    cell = R.LSTMCell(12, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    x, h, c, wh, wc = (rng.standard_normal(s).astype(np.float32)
                       for s in ((5, 12), (5, 8), (5, 8), (5, 8), (5, 8)))
    params = lstm_params(cell)
    jm = JaxLSTMCell(8)

    def loss(p, x, h, c):
        h2, c2 = jm.apply({"params": p}, x, (h, c))
        return jnp.sum(h2 * wh) + jnp.sum(c2 * wc)

    want, (gp, gx, gh, gc) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
        params, x, h, c)
    tx, th, tc = (torch.from_numpy(a).requires_grad_() for a in (x, h, c))
    h2, c2 = cell(tx, (th, tc))
    got = (h2 * torch.from_numpy(wh)).sum() + (c2 * torch.from_numpy(wc)).sum()
    got.backward()
    _close(got.item(), float(want), FWD_TOL, "loss")
    for g, w, what in ((tx.grad, gx, "dx"), (th.grad, gh, "dh"), (tc.grad, gc, "dc")):
        _close(g, w, GRAD_TOL, what)
    for name, g in lstm_params(cell, get=lambda t: t.grad.numpy()).items():
        _close(g, gp[name], GRAD_TOL, name)


@pytest.mark.parametrize("num_layers,bidirectional", [(1, False), (1, True), (2, False),
                                                      (2, True)])
def test_lstm_forward_and_gradients_match_jax(num_layers, bidirectional):
    """Outputs and (h_n, c_n) within 1e-5, the input's and every parameter's
    gradient within 1e-4, on a padded batch: the reverse direction reads the
    padded tail first, in both."""
    rng = np.random.default_rng(2)
    U, _, um = _meld_inputs(3, 10)
    port = R.LSTM(10, 6, num_layers, bidirectional, generator=torch.Generator().manual_seed(1),
                  device="cpu")
    params = lstm_params(port)
    jm = JaxLSTM(hidden_size=6, num_layers=num_layers, bidirectional=bidirectional)
    dirs = 2 if bidirectional else 1
    w_out = rng.standard_normal((L, B, dirs * 6)).astype(np.float32)
    w_hc = rng.standard_normal((2, num_layers * dirs, B, 6)).astype(np.float32)

    def loss(p, x):
        out, (h_n, c_n) = jm.apply({"params": p}, x)
        return jnp.sum(out * w_out) + jnp.sum(h_n * w_hc[0]) + jnp.sum(c_n * w_hc[1]), (out, h_n, c_n)

    (want, outs), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, U)
    tx = torch.from_numpy(U).requires_grad_()
    out, (h_n, c_n) = port(tx)
    got = ((out * torch.from_numpy(w_out)).sum() + (h_n * torch.from_numpy(w_hc[0])).sum()
           + (c_n * torch.from_numpy(w_hc[1])).sum())
    got.backward()
    for g, w, what in ((out, outs[0], "out"), (h_n, outs[1], "h_n"), (c_n, outs[2], "c_n")):
        assert g.shape == w.shape, what
        _close(g.detach(), w, FWD_TOL, what)
    _close(tx.grad, gx, GRAD_TOL, "dx")
    grads = lstm_params(port, get=lambda t: t.grad.numpy())
    assert set(grads) == set(gp)
    for name, g in grads.items():
        _close(g, gp[name], GRAD_TOL, name)


def test_lstm_dropout_between_layers_by_distribution(monkeypatch):
    """Train mode: dropout on every layer's output but the last (3 sites
    for 4 layers), each zeroing a fraction within 5 sigma of the rate and
    scaling the kept values by 1 / (1 - rate); eval mode: none."""
    rate, calls = 0.6, []
    dropout = R.F.dropout

    def recording(x, p, training):
        y = dropout(x, p, training)
        calls.append((x.detach(), y.detach(), p, training))
        return y

    monkeypatch.setattr(R.F, "dropout", recording)
    port = R.LSTM(10, 16, 4, True, dropout=rate, generator=torch.Generator().manual_seed(2),
                  device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((20, 8, 10)).astype(np.float32))
    torch.manual_seed(0)
    with torch.no_grad():
        port.train()(x)
        assert len(calls) == 3 and all(p == rate and t for _, _, p, t in calls)
        for x_in, y, _, _ in calls:
            assert x_in.shape == (20, 8, 32)
            kept = y != 0
            n = x_in.numel()
            frac = 1.0 - kept.double().mean().item()
            assert abs(frac - rate) <= 5 * math.sqrt(rate * (1 - rate) / n), frac
            torch.testing.assert_close(y[kept], x_in[kept] / (1 - rate))
        calls.clear()
        port.eval()(x)
        assert all(not t for _, _, _, t in calls)


# (c) MELDLSTMModel


def _jax_meld(dims, seed=0, **kw):
    U, qm, um = _meld_inputs(seed, dims["D_m"])
    jm = JaxMELDLSTMModel(**dims, n_classes=C, **kw)
    params = jax.jit(lambda k: jm.init({"params": k}, U, qm, um)["params"])(
        jax.random.PRNGKey(seed))
    return jm, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dims,att2", [(SMALL, True), (SMALL, False), (PUBLISHED, True)],
                         ids=["small", "small-att2-off", "published"])
def test_meld_model_matches_jax_through_the_weight_bridge(dims, att2):
    jm, params = _jax_meld(dims, att2=att2)
    port = MELDLSTMModel(**dims, n_classes=C, att2=att2, device="cpu")
    port.load_state_dict(meld_state_dict_from_jax(params))
    U, qm, um = _meld_inputs(5, dims["D_m"])
    want = jax.jit(lambda p: jm.apply({"params": p}, U, qm, um))(params)
    with torch.no_grad():
        lp, alpha = port.eval()(*(torch.from_numpy(a) for a in (U, qm, um)), valid_len=3)
    assert lp.dtype == torch.float32 and lp.shape == (L, B, C)
    _close(lp, want[0], FWD_TOL, "log_prob")
    if att2:
        assert alpha.shape == (L, B, L)
        _close(alpha, want[1], FWD_TOL, "alpha")
    else:
        assert alpha is None and want[1] == []


@pytest.mark.parametrize("case", ["bf16 compute", "bf16 parameters"])
def test_meld_model_at_bf16_matches_jax(case):
    from gan_ffn_tpu.serving import bf16_variant as jax_bf16_variant
    from gan_ffn_tpu_torch.serving import bf16_variant

    jm, params = _jax_meld(SMALL)
    port = MELDLSTMModel(**SMALL, n_classes=C, device="cpu")
    port.load_state_dict(meld_state_dict_from_jax(params))
    if case == "bf16 compute":  # float32 parameters cast at each use (--bf16)
        jm_b, jp = JaxMELDLSTMModel(**SMALL, n_classes=C, dtype=jnp.bfloat16), params
        port_b = MELDLSTMModel(**SMALL, n_classes=C, device="cpu", dtype=torch.bfloat16)
        port_b.load_state_dict(port.state_dict())
        assert next(port_b.parameters()).dtype == torch.float32
    else:  # every parameter stored as bf16 (serving.bf16_variant)
        jm_b, jp = jax_bf16_variant(jm, params)
        port_b = bf16_variant(port)
        assert all(p.dtype == torch.bfloat16 for p in port_b.parameters())
    U, qm, um = _meld_inputs(6, SMALL["D_m"])
    want = jax.jit(lambda p: jm_b.apply({"params": p}, U, qm, um))(jp)
    with torch.no_grad():
        lp, alpha = port_b.eval()(*(torch.from_numpy(a) for a in (U, qm, um)))
    assert lp.dtype == torch.float32 and alpha.dtype == torch.bfloat16
    assert np.abs(lp.numpy() - np.asarray(want[0])).max() <= BF16_TOL
    assert np.abs(alpha.float().numpy() - np.asarray(want[1], np.float32)).max() <= BF16_TOL


# (d) one deterministic train step with Adam

EPS = 1e-3  # Adam's eps raised in both frameworks, as tests/test_torch_train.py does


def _batches(path, n):
    return [b for _, b in zip(range(n), get_meld_loaders(path, batch_size=B, seed=1)[0])]


@pytest.fixture(scope="module")
def meld_fixture(tmp_path_factory):
    """A synthetic MELD pickle of 12 + 5 dialogues of 3-16 utterances (at
    the small width D_m 24 its text is cut to 24 columns by the tests)."""
    path = tmp_path_factory.mktemp("meld") / "MELD_features_raw.pkl"
    return write_synthetic_meld(str(path), n_train=12, n_test=5, min_len=3, max_len=16, seed=4)


def _narrow(batch, D_m):
    batch.text = np.ascontiguousarray(batch.text[..., :D_m])
    return batch


def _port_step(params, dtype=None):
    port = MELDLSTMModel(**SMALL, n_classes=C, device="cpu", dtype=dtype)
    port.load_state_dict(meld_state_dict_from_jax(params))
    opt = torch_adam(port.parameters(), 3e-4, eps=EPS, weight_decay=1e-4)
    train_step, _ = make_classifier_steps(port, opt, C, deterministic=True)
    assert train_step.seeds is None  # no kernel draws a seed
    return port, train_step


def test_deterministic_train_step_matches_jax(meld_fixture):
    """The loss and the parameters after 2 Adam steps (unweighted masked
    NLL, lr 3e-4, L2 1e-4: the trainer's) on the loader's batches of one
    shape: loss 1e-5 relative, parameters 1e-5."""
    batches = [_narrow(b, SMALL["D_m"]) for b in _batches(meld_fixture, 2)]
    assert len({b.seq_len for b in batches}) == 1
    jm, params = _jax_meld(SMALL)

    def apply_eval(p, a):
        out = jm.apply({"params": p}, a["text"], a["qmask"], a["umask"])
        return out[0], {"alpha": out[1]}

    jadam = jax_adam(3e-4, eps=EPS, weight_decay=1e-4)
    jtrain, _ = jax_steps(lambda p, rng, a: apply_eval(p, a)[0], apply_eval, jadam, C)
    state = init_classifier_state(jax.tree.map(jnp.copy, params), jadam)
    port, train_step = _port_step(params)
    for i, batch in enumerate(batches):
        state, want, _ = jtrain(state, jax.random.PRNGKey(i), batch_to_arrays(batch, False), 1.0)
        loss, _ = train_step(batch_to_tensors(batch, "cpu"))
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want = meld_state_dict_from_jax(jax.tree.map(np.asarray, state["params"]))
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_deterministic_bf16_train_step_matches_jax(meld_fixture):
    """``--bf16``: the loss within 1e-2 relative and every gradient the
    update applied within 5e-2 of max(1, max |ref|), the CPU tests' limits
    at bf16 (tests/test_torch_bf16_train.py)."""
    from gan_ffn_tpu.nn.losses import masked_nll_loss

    batch = _narrow(_batches(meld_fixture, 1)[0], SMALL["D_m"])
    _, params = _jax_meld(SMALL)
    jm = JaxMELDLSTMModel(**SMALL, n_classes=C, dtype=jnp.bfloat16)
    a = batch_to_arrays(batch, False)

    def jax_loss(p):
        lp = jm.apply({"params": p}, a["text"], a["qmask"], a["umask"])[0]
        return masked_nll_loss(lp.transpose(1, 0, 2).reshape(-1, C), a["label"].reshape(-1),
                               a["umask"], None)

    want, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    port, train_step = _port_step(params, torch.bfloat16)
    loss, _ = train_step(batch_to_tensors(batch, "cpu"))
    assert abs(loss.item() - float(want)) <= BF16_TOL * abs(float(want))
    grads = meld_state_dict_from_jax(grads)
    for name, p in port.named_parameters():
        assert p.dtype == torch.float32
        ref = grads[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 5e-2 * max(1.0, np.abs(ref).max()), (name, err)


# (e) MELD data


def test_loaders_and_fixture_match_jax(tmp_path):
    kw = dict(n_train=23, n_test=9, min_len=3, max_len=33, seed=11, label_noise=0.2)
    port_path = write_synthetic_meld(str(tmp_path / "port.pkl"), **kw)
    jax_path = jax_write_synthetic_meld(str(tmp_path / "jax.pkl"), **kw)
    assert Path(port_path).read_bytes() == Path(jax_path).read_bytes()
    for classify in ("emotion", "sentiment"):
        port = get_meld_loaders(port_path, batch_size=5, classify=classify, seed=2)
        ref = jax_get_meld_loaders(jax_path, batch_size=5, classify=classify, seed=2)
        assert len(port[1]) == len(ref[1]) == 0  # valid 0.0: an empty valid loader
        for p_loader, j_loader in zip(port, ref):
            for _ in range(2):  # two epochs: the shuffles follow the epoch
                pb, jb = list(p_loader), list(j_loader)
                assert len(pb) == len(jb)
                for x, y in zip(pb, jb):
                    assert x.vids == y.vids and x.n_real == y.n_real and x.visual is None
                    assert x.seq_len in (16, 24, 33)
                    for k in ("text", "audio", "qmask", "umask", "label"):
                        np.testing.assert_array_equal(getattr(x, k), getattr(y, k), err_msg=k)
                        assert getattr(x, k).dtype == getattr(y, k).dtype, k
    with open(port_path, "rb") as f:
        assert len(pickle.load(f)) == 9


# (f) cli/train_meld.py on the CPU


def _cli(cwd, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "gan_ffn_tpu_torch.cli.train_meld", *args],
                           cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_trains_two_epochs_on_the_cpu(tmp_path):
    """The published widths on the default synthetic fixture (80 + 20
    dialogues of 3-33 utterances): the report, NaN valid metrics (valid
    0.0), the best epoch by highest test F1 and its checkpoint."""
    res = _cli(tmp_path, "--synthetic", "--device", "cpu", "--epochs", "2")
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [l for l in res.stdout.splitlines() if l.startswith("epoch ")]
    assert len(lines) == 2
    fields = [dict(zip(l.split()[::2], l.split()[1::2])) for l in lines]
    assert all(f["valid_loss"] == "nan" and f["val_fscore"] == "nan" for f in fields)
    assert all(math.isfinite(float(f["train_loss"])) for f in fields)
    best = max(float(f["test_fscore"]) for f in fields)
    assert f"F1-score {best}" in res.stdout
    path = tmp_path / "GAN_save" / "meld_classifier_best.msgpack"
    assert read_state_dict(path)["lstm.weight_ih_l0"].shape == (1200, 600)
    assert all_float32(path)
    assert (tmp_path / "data" / "meld" / "MELD_features_raw.pkl").exists()


@pytest.mark.parametrize("cadence", ["epoch", "batch"])
def test_cli_tensorboard_logs_scalars_and_histograms(tmp_path, monkeypatch, cadence):
    """``--tensorboard`` (refused before the JAX checkpoint slice): the two
    scalars per epoch and one histogram per named parameter, per epoch or
    per train batch.  ``--epoch-fused`` with the ``batch`` cadence is
    refused, as in JAX."""
    tb = pytest.importorskip("tensorboard")  # noqa: F841
    from tb_events import read_events

    data = write_synthetic_meld(str(tmp_path / "meld.pkl"), n_train=12, n_test=4, min_len=3,
                                max_len=8, seed=2)
    monkeypatch.chdir(tmp_path)
    CLI.main(["--data-path", data, "--device", "cpu", "--epochs", "2", "--batch-size", "8",
              "--tensorboard", "--tb-grad-histograms", cadence])
    scalars, hists = read_events(tmp_path / "tensorboard")
    assert sorted(scalars) == ["test: accuracy/loss", "train: accuracy/loss"]
    assert all(steps == [0, 1] for steps in scalars.values())
    names = [n for n, _ in MELDLSTMModel(D_m=600, D_e=300, D_h=600, n_classes=7,
                                         device="cpu").named_parameters()]
    assert sorted(hists) == sorted(names)
    per_epoch = 1 if cadence == "epoch" else 2  # 12 dialogues in batches of 8
    assert all(steps == [0] * per_epoch + [1] * per_epoch for steps in hists.values())
    if cadence == "batch":
        with pytest.raises(SystemExit) as exc:
            CLI.main(["--data-path", data, "--device", "cpu", "--epochs", "1", "--epoch-fused",
                      "--tensorboard", "--tb-grad-histograms", "batch"])
        assert exc.value.code == 2


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_epoch_fused_matches_the_per_batch_loop_bit_for_bit(tmp_path, monkeypatch, bf16):
    """On a fixture whose dialogues all fall in the 16 bucket, with every
    dropout on: 2 epochs per batch and with --epoch-fused give the same
    epoch lines and the same checkpoint bits (f32, and --bf16, whose
    checkpoint stays float32)."""
    data = write_synthetic_meld(str(tmp_path / "meld.pkl"), n_train=40, n_test=8, min_len=3,
                                max_len=16, seed=6)
    monkeypatch.chdir(tmp_path)
    out = {}
    for fused in (False, True):
        save = tmp_path / f"save_{fused}"
        argv = ["--data-path", data, "--device", "cpu", "--epochs", "2", "--batch-size", "16",
                "--model-save-path", str(save)] + ["--epoch-fused"] * fused + ["--bf16"] * bf16
        res = CLI.main(argv)
        out[fused] = (res, read_state_dict(save / "meld_classifier_best.msgpack"))
    (r0, s0), (r1, s1) = out[False], out[True]
    assert (r0["best_loss"], r0["f1"]) == (r1["best_loss"], r1["f1"])
    assert set(s0) == set(s1)
    for k in s0:
        assert s0[k].dtype == torch.float32
        assert torch.equal(s0[k], s1[k]), k
    a0, a1 = r0["attentions"], r1["attentions"]
    assert a0["vids"] == a1["vids"]
    for x, y in zip(a0["alpha"], a1["alpha"]):
        np.testing.assert_array_equal(x, y)


# (g) the F1 band of the JAX package's MELD pipeline, from the port's own init


@pytest.mark.slow
def test_meld_pipeline_f1_band(tmp_path, monkeypatch):
    """The band of tests/test_train.py::test_meld_pipeline_f1_band (F1
    70.5-79.5, best loss 0.9-2.2 after 25 epochs) from the port's own init,
    on the same fixture (120 + 40 dialogues of 3-24 utterances, label noise
    0.25, seed 3407)."""
    fixture = str(tmp_path / "MELD_features_raw.pkl")
    write_synthetic_meld(fixture, n_train=120, n_test=40, min_len=3, max_len=24,
                         class_spread=2.0, label_noise=0.25, seed=3407)
    monkeypatch.chdir(tmp_path)
    res = CLI.main(["--data-path", fixture, "--epochs", "25", "--device", "cpu"])
    assert 70.5 <= res["f1"] <= 79.5, res
    assert 0.9 <= float(res["best_loss"]) <= 2.2, res
