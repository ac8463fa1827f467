"""The port's sweeps on the CPU at depth 1: the GAN-epoch sweep
(``cli/sweep.py``), the multi-seed sweep (``cli/seed_sweep.py``) and the
per-seed sweep step (``parallel/sweep.py``) against the JAX package's
vmapped one.  Torch runs on one intra-op thread wherever bits are compared.
"""

from __future__ import annotations

import ast
import contextlib
import csv
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_ffn_tpu.cli.common import IEMOCAP_LOSS_WEIGHTS, make_gan_ffn_apply_fns
from gan_ffn_tpu.models import GAN_FFN as JaxGAN_FFN
from gan_ffn_tpu.parallel.sweep import init_seed_sweep as jax_init_seed_sweep
from gan_ffn_tpu.parallel.sweep import make_seed_mesh as jax_make_seed_mesh
from gan_ffn_tpu.parallel.sweep import make_sweep_train_step as jax_make_sweep_train_step
from gan_ffn_tpu.train.classifier import init_classifier_state
from gan_ffn_tpu.train.classifier import make_classifier_steps as jax_steps
from gan_ffn_tpu.train.optim import torch_adam as jax_adam
from gan_ffn_tpu_torch.cli import seed_sweep as SS
from gan_ffn_tpu_torch.cli import sweep as SW
from gan_ffn_tpu_torch.cli.common import generator_weights, train_gan
from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
from gan_ffn_tpu_torch.models import GAN_FFN
from gan_ffn_tpu_torch.parallel import make_sweep_train_step
from gan_ffn_tpu_torch.train.classifier import make_classifier_steps
from gan_ffn_tpu_torch.train.gan import GANConfig
from gan_ffn_tpu_torch.train.optim import torch_adam
from gan_ffn_tpu_torch.utils.weights import gan_ffn_state_dict_from_jax

EPS = 1e-3  # Adam eps in both frameworks, as tests/test_torch_train.py (EPS) explains
COMMON = ["--num-layers", "1", "--device", "cpu", "--seed", "0"]


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _main(cli, argv):
    out = io.StringIO()
    with one_thread(), contextlib.redirect_stdout(out):
        result = cli.main(argv)
    return result, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """One bucket (32): AUTO fuses the epochs."""
    return write_synthetic_iemocap(str(tmp_path_factory.mktemp("data") / "iemocap.pkl"),
                                   n_train=16, n_test=6, min_len=4, max_len=12, seed=0)


@pytest.fixture(scope="module")
def gan_sweep(tmp_path_factory, data):
    """``cli/sweep.py --gan-epochs 1 2 1 --epochs 1``, its snapshots captured."""
    out = tmp_path_factory.mktemp("sweep")
    snapshots = {}
    real = SW.stage_a_snapshots

    def capture(*args, **kw):
        snaps, history = real(*args, **kw)
        snapshots.update(snaps)
        return snaps, history

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SW, "stage_a_snapshots", capture)
        results, log = _main(SW, ["--gan-epochs", "1", "2", "1", "--epochs", "1", "--data-path",
                                  data, "--output-dir", str(out), *COMMON])
    return results, snapshots, out, log


def test_sweep_writes_a_report_per_point_and_the_loss_history(gan_sweep):
    results, _, out, log = gan_sweep
    assert sorted(results) == [1, 2] and all(0.0 <= f <= 100.0 for f in results.values())
    reports = sorted(p.name for p in (out / "history").iterdir())
    assert reports == [f"test_out_GAN-epochs={g}_F1-score={results[g]}.txt" for g in (1, 2)]
    with open(out / "GAN_loss.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    assert any(l.startswith("--epoch-fused AUTO:") and "-> fused" in l for l in log)
    assert [l for l in log if l.startswith("snapshotted")] == [
        "snapshotted generators at GAN epoch 1", "snapshotted generators at GAN epoch 2"]
    best = max(results, key=results.get)
    assert log[-1] == f"best: GAN-epochs={best} F1={results[best]}"


def test_snapshot_is_an_uninterrupted_stage_a(gan_sweep, data):
    """Snapshot 2 is a 2-epoch ``train_gan`` run in one go, in bits (the
    sweep's segments continue one seed stream); snapshot 1 is not."""
    _, snapshots, _, _ = gan_sweep
    loader = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)[0]
    torch.manual_seed(1)
    with one_thread():
        state, _ = train_gan(GANConfig(num_layers=1, seed=0), loader, 2, device="cpu",
                             epoch_fused=True, log=lambda line: None)
    want = generator_weights(state)
    assert set(snapshots[2]) == set(want) == set(snapshots[1])
    assert all(torch.equal(snapshots[2][k], v) for k, v in want.items())
    assert not all(torch.equal(snapshots[1][k], v) for k, v in want.items())


def test_sweep_warns_about_an_existing_fixture_and_refuses_an_empty_range(data, capsys):
    with pytest.raises(SystemExit) as exc:
        SW.main(["--synthetic", "--data-path", data, "--gan-epochs", "3", "1", "1", *COMMON])
    assert exc.value.code == 2
    captured = capsys.readouterr()
    assert "WARNING:" in captured.out and "gives no sweep point" in captured.err


def _best_losses(log):
    line = next(l for l in log if l.startswith("best test loss per seed:"))
    return ast.literal_eval(line.split(":", 1)[1].strip())


@pytest.fixture(scope="module")
def seed_runs(tmp_path_factory, data):
    """Seeds [0, 1] (with a stage A of 0 epochs, saved), then [0] and [1]
    alone from the saved networks."""
    save = str(tmp_path_factory.mktemp("gan_save"))
    argv = ["--epochs", "2", "--data-path", data, "--model-save-path", save, *COMMON]
    runs = {(0, 1): _main(SS, ["--seeds", "0", "1", "--GAN-epochs", "0", *argv])}
    for s in (0, 1):
        runs[(s,)] = _main(SS, ["--seeds", str(s), "--use-trained-GAN", *argv])
    return runs


def test_seed_sweep_seeds_equal_their_runs_alone(seed_runs):
    results, log = seed_runs[(0, 1)]
    losses = _best_losses(log)
    for s in (0, 1):
        alone, alone_log = seed_runs[(s,)]
        assert "loaded trained GAN" in "\n".join(alone_log)
        assert alone == {s: results[s]}
        assert _best_losses(alone_log) == {s: losses[s]}


def test_seed_sweep_prints_each_epoch_and_the_seeds_diverge(seed_runs):
    results, log = seed_runs[(0, 1)]
    epochs = [l for l in log if l.startswith("epoch ")]
    assert len(epochs) == 2 and all("train_loss/seed [" in l and "test_f1/seed [" in l
                                    for l in epochs)
    losses = _best_losses(log)
    assert losses[0] != losses[1] and all(np.isfinite(v) for v in losses.values())
    assert log[-2] == f"best F1 per seed: {results}"


def test_sweep_step_matches_jax_vmapped(cpu_devices):
    """One deterministic step of two seeds from JAX's stacked params, split
    per seed: the port's per-seed steps against JAX's vmapped step on a
    2-device seed mesh (loss 1e-5 relative, parameters 1e-6)."""
    rng = np.random.default_rng(4)
    L, B = 8, 4
    umask = (np.arange(L)[None, :] < np.array([8, 6, 3, 0])[:, None]).astype(np.float32)
    host = {"audio": rng.standard_normal((L, B, 100)), "visual": rng.standard_normal((L, B, 512)),
            "text": rng.standard_normal((L, B, 100))}
    host = {k: v.astype(np.float32) for k, v in host.items()}
    host.update(umask=umask, label=(rng.integers(0, 6, (B, L)) * umask).astype(np.int64))
    jm = JaxGAN_FFN(n_classes=6, gen_num_layers=1)
    _, apply_eval = make_gan_ffn_apply_fns(jm)
    opt = jax_adam(1e-3, eps=EPS, weight_decay=0.008)
    weights = jnp.asarray(IEMOCAP_LOSS_WEIGHTS)
    jtrain, _ = jax_steps(lambda p, key, b: apply_eval(p, b), apply_eval, opt, 6, weights)
    mesh = jax_make_seed_mesh(cpu_devices[:2])
    jbatch = {**{k: jnp.asarray(v) for k, v in host.items()},
              "valid_len": jnp.asarray(L, jnp.int32), "n_real": jnp.asarray(3, jnp.int32)}

    def init_fn(key):
        params = jm.init(key, jbatch["audio"], jbatch["visual"], jbatch["text"])["params"]
        return init_classifier_state(params, opt)

    stacked = jax_init_seed_sweep(init_fn, [0, 1], mesh)
    before = jax.tree.map(np.asarray, stacked["params"])  # the step donates its state
    keys = jnp.stack([jax.random.PRNGKey(0), jax.random.PRNGKey(1)])
    stacked, jlosses, _ = jax_make_sweep_train_step(jtrain, mesh)(stacked, keys, jbatch)
    after = jax.tree.map(np.asarray, stacked["params"])

    models, steps = [], []
    for i in range(2):
        model = GAN_FFN(n_classes=6, gen_num_layers=1, device="cpu")
        model.load_state_dict(gan_ffn_state_dict_from_jax(jax.tree.map(lambda x: x[i], before)))
        steps.append(make_classifier_steps(
            model, torch_adam(model.parameters(), 1e-3, eps=EPS, weight_decay=0.008), 6,
            torch.from_numpy(IEMOCAP_LOSS_WEIGHTS), deterministic=True)[0])
        models.append(model)
    batch = {**{k: torch.from_numpy(v) for k, v in host.items()},
             "valid_len": torch.tensor(L, dtype=torch.int32),
             "n_real": torch.tensor(3, dtype=torch.int32)}
    outs = make_sweep_train_step(steps)(batch)
    np.testing.assert_allclose([o[0].item() for o in outs], np.asarray(jlosses), rtol=1e-5)
    for i, model in enumerate(models):
        want = gan_ffn_state_dict_from_jax(jax.tree.map(lambda x: x[i], after))
        got = model.state_dict()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
