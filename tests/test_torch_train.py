"""Stage B of the port (losses, optimizer, data, evaluation, the classifier
step, the epoch loop and cli/train_iemocap.py) against the JAX package, on
the CPU.

The port's kernels run their plain versions here.  The JAX side runs its XLA
paths (conftest sets ``GANFFN_PALLAS=0``).  Inputs come from numpy with a
seed, or from the synthetic IEMOCAP fixture.  Tolerances are stated per test.
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

from gan_ffn_tpu.cli.common import IEMOCAP_LOSS_WEIGHTS, make_gan_ffn_apply_fns
from gan_ffn_tpu.data import get_iemocap_loaders as jax_loaders
from gan_ffn_tpu.data import write_synthetic_iemocap as jax_write_synthetic
from gan_ffn_tpu.evaluation import metrics as JMET
from gan_ffn_tpu.evaluation import reports as JREP
from gan_ffn_tpu.models import GAN_FFN as JaxGAN_FFN
from gan_ffn_tpu.nn.losses import masked_nll_loss as jax_masked_nll_loss
from gan_ffn_tpu.train.classifier import init_classifier_state
from gan_ffn_tpu.train.classifier import make_classifier_steps as jax_steps
from gan_ffn_tpu.train.loop import batch_to_arrays
from gan_ffn_tpu.train.loop import run_epoch as jax_run_epoch
from gan_ffn_tpu.train.optim import torch_adam as jax_adam
from gan_ffn_tpu_torch.cli import train_iemocap as CLI
from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
from gan_ffn_tpu_torch.evaluation import metrics as TMET
from gan_ffn_tpu_torch.evaluation import reports as TREP
from gan_ffn_tpu_torch.models import GAN_FFN
from gan_ffn_tpu_torch.nn.losses import masked_nll_loss
from gan_ffn_tpu_torch.train.classifier import graft_generator_params, make_classifier_steps
from gan_ffn_tpu_torch.train.loop import batch_to_tensors, run_epoch
from gan_ffn_tpu_torch.train.optim import torch_adam
from gan_ffn_tpu_torch.utils.weights import gan_ffn_state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
C = 6


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_nll_loss_matches_jax(weighted):
    """rtol 1e-6: the same f32 sums."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, C)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    target = rng.integers(0, C, 40)
    mask = (rng.random((4, 10)) < 0.7).astype(np.float32)
    w = IEMOCAP_LOSS_WEIGHTS if weighted else None
    got = masked_nll_loss(torch.from_numpy(lp), torch.from_numpy(target), torch.from_numpy(mask),
                          None if w is None else torch.from_numpy(w))
    want = jax_masked_nll_loss(jnp.asarray(lp), jnp.asarray(target), jnp.asarray(mask),
                               None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_torch_adam_matches_jax():
    """Three updates from the same grads, coupled L2: atol 5e-7, a few f32
    ulps of parameters of order 1 (the two compute the update in another
    order)."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((5, 4)).astype(np.float32)
    grads = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(3)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch_adam([param], 1e-2, weight_decay=0.008)
    jopt = jax_adam(1e-2, weight_decay=0.008)
    jp = jnp.asarray(p0)
    state = jopt.init(jp)
    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
        updates, state = jopt.update(jnp.asarray(g), state, jp)
        jp = jp + updates
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=0, atol=5e-7)


def test_synthetic_fixture_and_loaders_match_jax(tmp_path):
    """The port's writer gives the JAX writer's pickle, and its loaders give
    identical batches, epoch after epoch."""
    kw = dict(n_train=20, n_test=6, min_len=4, max_len=70, seed=5)
    port_path = write_synthetic_iemocap(str(tmp_path / "port.pkl"), **kw)
    jax_path = jax_write_synthetic(str(tmp_path / "jax.pkl"), **kw)
    assert Path(port_path).read_bytes() == Path(jax_path).read_bytes()
    ours = get_iemocap_loaders(port_path, batch_size=4, seed=5)
    theirs = jax_loaders(jax_path, batch_size=4, seed=5)
    for _ in range(2):
        for a, b in zip(ours, theirs):
            batches = list(zip(a, b))
            assert len(batches) == len(a) == len(b)
            for x, y in batches:
                for name in ("text", "audio", "visual", "qmask", "umask", "label"):
                    np.testing.assert_array_equal(getattr(x, name), getattr(y, name))
                assert x.vids == y.vids and x.n_real == y.n_real


def test_metrics_and_report_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    labels, preds = rng.integers(0, C, 300), rng.integers(0, C, 300)
    masks = (rng.random(300) < 0.8).astype(np.float32)
    for name in ("accuracy_score",):
        assert getattr(TMET, name)(labels, preds, masks) == getattr(JMET, name)(labels, preds, masks)
    for avg in ("weighted", "macro", "micro"):
        assert TMET.f1_score(labels, preds, sample_weight=masks, average=avg) == \
            JMET.f1_score(labels, preds, sample_weight=masks, average=avg)
    np.testing.assert_array_equal(TMET.confusion_matrix(labels, preds, sample_weight=masks),
                                  JMET.confusion_matrix(labels, preds, sample_weight=masks))
    assert TREP.format_test_report(1.2345, labels, preds, masks) == \
        JREP.format_test_report(1.2345, labels, preds, masks)
    ours = TREP.write_test_report(str(tmp_path / "a"), 0, 1.2345, labels, preds, masks)
    theirs = JREP.write_test_report(str(tmp_path / "b"), 0, 1.2345, labels, preds, masks)
    assert Path(ours).name == Path(theirs).name
    assert Path(ours).read_text() == Path(theirs).read_text()


def test_graft_generator_params_takes_the_gan_generators():
    model = GAN_FFN(gen_num_layers=1, generator=torch.Generator().manual_seed(0), device="cpu")
    other = GAN_FFN(gen_num_layers=1, generator=torch.Generator().manual_seed(1), device="cpu")
    gan_state = {}
    for clf_key, gan_key in (("acoustic_generator", "acoustic_gen"),
                             ("visual_generator", "visual_gen"), ("text_generator", "text_gen")):
        for k, v in getattr(other, clf_key).state_dict().items():
            gan_state[f"{gan_key}.{k}"] = v
    grafted = graft_generator_params(model.state_dict(), gan_state)
    for k, v in grafted.items():
        source = other.state_dict()[k] if not k.startswith("fc.") else model.state_dict()[k]
        assert torch.equal(v, source), k
    del gan_state["text_gen.net.fc2.bias"]
    with pytest.raises(KeyError, match="text_gen.net.fc2.bias"):
        graft_generator_params(model.state_dict(), gan_state)


@pytest.fixture(scope="module")
def stage_b(tmp_path_factory):
    """A 1-layer JAX GAN_FFN, the port's copy of it, and small batches of the
    synthetic fixture (B=4, buckets 32 and 64)."""
    path = write_synthetic_iemocap(str(tmp_path_factory.mktemp("data") / "iemocap.pkl"),
                                   n_train=12, n_test=4, min_len=4, max_len=40, seed=3)
    train, _, test = get_iemocap_loaders(path, batch_size=4, seed=3)
    batches = list(train)[:3]
    jm = JaxGAN_FFN(n_classes=C, gen_num_layers=1)
    a = batch_to_arrays(batches[0])
    params = jm.init(jax.random.PRNGKey(0), a["audio"], a["visual"], a["text"])["params"]
    return jm, params, batches, test


def _port_model(params):
    model = GAN_FFN(n_classes=C, gen_num_layers=1, device="cpu")
    model.load_state_dict(gan_ffn_state_dict_from_jax(params))
    return model


# Adam's eps is raised from 1e-8 to 1e-3 in both frameworks for the step
# tests: parameters whose gradient is zero in exact arithmetic (the key bias
# of in_proj, which softmax ignores) get noise-level gradients of ~1e-9 whose
# sign differs between the frameworks, and eps 1e-8 would turn that noise
# into full lr-sized updates of either sign.
EPS = 1e-3


def test_deterministic_step_matches_jax(stage_b):
    """Loss and every gradient of the deterministic forward (rtol 1e-4, atol
    1e-6), then the params after 3 Adam steps with the lr_scale of the decay
    schedule (atol 1e-6), against the JAX step built from the eval apply."""
    jm, params, batches, _ = stage_b
    weights = jnp.asarray(IEMOCAP_LOSS_WEIGHTS)
    _, apply_eval = make_gan_ffn_apply_fns(jm)

    def jax_loss(p, arrays):
        lp = apply_eval(p, arrays).transpose(1, 0, 2).reshape(-1, C)
        return jax_masked_nll_loss(lp, arrays["label"].reshape(-1), arrays["umask"], weights)

    arrays = [batch_to_arrays(b) for b in batches]
    want_loss, want_grads = jax.value_and_grad(jax_loss)(params, arrays[0])

    model = _port_model(params)
    opt = torch_adam(model.parameters(), 1e-3, eps=EPS, weight_decay=0.008)
    train_step, _ = make_classifier_steps(model, opt, C, torch.from_numpy(IEMOCAP_LOSS_WEIGHTS),
                                          deterministic=True)
    loss, preds = train_step(batch_to_tensors(batches[0], "cpu"))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_preds = np.asarray(apply_eval(params, arrays[0]).transpose(1, 0, 2).reshape(-1, C).argmax(1))
    np.testing.assert_array_equal(preds.numpy(), want_preds)
    grads = gan_ffn_state_dict_from_jax(want_grads)
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    jtrain, _ = jax_steps(lambda p, rng, b: apply_eval(p, b), apply_eval,
                          jax_adam(1e-3, eps=EPS, weight_decay=0.008), C, weights)
    # the JAX step donates its state: hand it a copy of the shared params
    state = init_classifier_state(jax.tree.map(jnp.copy, params),
                                  jax_adam(1e-3, eps=EPS, weight_decay=0.008))
    state, _, _ = jtrain(state, jax.random.PRNGKey(0), arrays[0], 1.0)
    for e, (batch, arr) in enumerate(zip(batches[1:], arrays[1:]), start=1):
        train_step(batch_to_tensors(batch, "cpu"), 0.98**e)
        state, _, _ = jtrain(state, jax.random.PRNGKey(e), arr, 0.98**e)
    want = gan_ffn_state_dict_from_jax(jax.tree.map(np.asarray, state["params"]))
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_eval_epoch_matches_jax(stage_b):
    """The eval epoch's loss (rtol 1e-5), predictions, labels, masks and
    metrics against the JAX loop on the same params."""
    jm, params, _, test = stage_b
    weights = IEMOCAP_LOSS_WEIGHTS
    _, apply_eval = make_gan_ffn_apply_fns(jm)
    _, jeval = jax_steps(lambda p, rng, b: apply_eval(p, b), apply_eval, jax_adam(1e-3), C,
                         jnp.asarray(weights))
    want = jax_run_epoch(test, params, eval_step=jeval)
    model = _port_model(params)
    opt = torch_adam(model.parameters(), 1e-3)
    _, eval_step = make_classifier_steps(model, opt, C, torch.from_numpy(weights))
    got = run_epoch(test, eval_step, "cpu")
    np.testing.assert_allclose(got.avg_loss, want.avg_loss, rtol=1e-5)
    for name in ("labels", "preds", "masks"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.avg_accuracy, got.avg_fscore) == (want.avg_accuracy, want.avg_fscore)


def test_train_epoch_updates_and_reports(stage_b):
    """A training epoch with every dropout on: finite loss, one update per
    batch, and .grad holding the last update's gradient."""
    _, params, batches, _ = stage_b
    model = _port_model(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch_adam(model.parameters(), 1e-3)
    train_step, _ = make_classifier_steps(model, opt, C)
    res = run_epoch(batches, train_step, "cpu", lr_scale=0.5)
    assert np.isfinite(res.avg_loss) and len(res.preds) == sum(b.umask.size for b in batches)
    assert opt.state[next(iter(model.parameters()))]["step"] == len(batches)
    assert all(g["lr"] == 0.5e-3 for g in opt.param_groups)
    assert any(not torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    assert all(p.grad is not None for p in model.parameters())
    assert model.training


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "gan_ffn_tpu_torch.cli.train_iemocap", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )


def test_cli_trains_on_the_cpu(tmp_path):
    res = _cli(tmp_path, "--synthetic", "--GAN-epochs", "0", "--epochs", "2", "--num-layers", "1",
               "--device", "cpu", "--synthetic-train", "16", "--synthetic-test", "6")
    assert res.returncode == 0, res.stderr
    epochs = [l for l in res.stdout.splitlines() if l.startswith("epoch ")]
    assert len(epochs) == 2 and all("train_loss" in l and "utt/s" in l for l in epochs)
    reports = list((tmp_path / "output").glob("test_out_GAN-epochs=0_F1-score=*.txt"))
    assert len(reports) == 1 and reports[0].read_text().startswith("Loss ")
    state = torch.load(tmp_path / "GAN_save" / "classifier_best.pt", weights_only=True)
    assert set(state) == set(GAN_FFN(gen_num_layers=1, device="cpu").state_dict())


@pytest.mark.parametrize("flags,item", [
    (["--GAN-epochs", "0", "--epoch-fused", "--gan-schedule", "stepwise"],
     "--gan-schedule stepwise"),
    (["--GAN-epochs", "0", "--bf16"], "Queue 1 item 4"),
    (["--GAN-epochs", "0", "--dp"], "module note 13"),
])
def test_cli_refuses_what_later_slices_bring(flags, item, capsys):
    with pytest.raises(SystemExit) as exc:
        CLI.main(["--device", "cpu", *flags])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err
