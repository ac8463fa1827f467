"""Stage A of the port (``bce_loss``, the discriminators, the weight bridge
of the six GAN networks, the 12-duel step, its checkpoints and the trainer's
stage A) against the JAX package, on the CPU.

The port's kernels run their plain versions here.  The JAX side runs its
XLA paths (conftest sets ``GANFFN_PALLAS=0``).  Depth 1-2, L = 16, B = 4,
with ``valid_len < L`` and ``n_real < B`` so that the duel mask matters.
Inputs come from numpy with a seed.  Tolerances are stated per test.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_ffn_tpu.models import AcousticDiscriminator as JaxAcousticDiscriminator
from gan_ffn_tpu.models import TextDiscriminator as JaxTextDiscriminator
from gan_ffn_tpu.models import VisualDiscriminator as JaxVisualDiscriminator
from gan_ffn_tpu.nn.losses import bce_loss as jax_bce_loss
from gan_ffn_tpu.train import gan as JG
from gan_ffn_tpu.train.optim import torch_adam as jax_adam
from gan_ffn_tpu_torch.cli import train_iemocap as CLI
from gan_ffn_tpu_torch.cli.common import train_gan
from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
from gan_ffn_tpu_torch.models import AcousticDiscriminator, TextDiscriminator, VisualDiscriminator
from gan_ffn_tpu_torch.nn.losses import bce_loss
from gan_ffn_tpu_torch.train import gan as TG
from gan_ffn_tpu_torch.utils.checkpoint import load_gan_state, save_gan_state
from gan_ffn_tpu_torch.utils.weights import gan_state_dicts_from_jax, state_dict_from_jax

L, B, VALID_LEN, N_REAL = 16, 4, 12, 3
DIMS = {"audio": 100, "visual": 512, "text": 100}
# Adam's eps is 1e-3 in both frameworks for the step tests, for the reason
# given in tests/test_torch_train.py (EPS): gradients that are zero in exact
# arithmetic come out as noise of either sign.
EPS = 1e-3


def _batch():
    rng = np.random.default_rng(0)
    host = {k: rng.standard_normal((L, B, d)).astype(np.float32) for k, d in DIMS.items()}
    return host, {**{k: torch.from_numpy(v) for k, v in host.items()},
                  "valid_len": VALID_LEN, "n_real": N_REAL}


@pytest.mark.parametrize("target", [0.0, 1.0])
@pytest.mark.parametrize("masked", [False, True])
def test_bce_loss_matches_jax(target, masked):
    """Forward and gradient against the JAX ``bce_loss`` (rtol 1e-6), with
    predictions at exactly 0 and 1: the -100 clamp and a finite gradient."""
    rng = np.random.default_rng(1)
    pred = (1 / (1 + np.exp(-2 * rng.standard_normal((L, B, 1))))).astype(np.float32)
    pred[0, 0, 0], pred[1, 0, 0], pred[2, 1, 0], pred[3, 2, 0] = 0.0, 1.0, 0.0, 1.0
    tgt = np.full_like(pred, target)
    mask = (np.arange(L)[:, None, None] < VALID_LEN) & (np.arange(B)[None, :, None] < N_REAL)
    mask = mask.astype(np.float32) if masked else None

    p = torch.from_numpy(pred).requires_grad_()
    loss = bce_loss(p, torch.from_numpy(tgt), None if mask is None else torch.from_numpy(mask))
    loss.backward()
    want, want_grad = jax.value_and_grad(
        lambda x: jax_bce_loss(x, jnp.asarray(tgt), None if mask is None else jnp.asarray(mask))
    )(jnp.asarray(pred))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    assert np.isfinite(p.grad.numpy()).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-6)


@pytest.mark.parametrize("port_cls,jax_cls,width", [
    (AcousticDiscriminator, JaxAcousticDiscriminator, 100),
    (VisualDiscriminator, JaxVisualDiscriminator, 512),
    (VisualDiscriminator, JaxVisualDiscriminator, 100),
    (TextDiscriminator, JaxTextDiscriminator, 100),
])
def test_discriminator_matches_jax(port_cls, jax_cls, width):
    """Deterministic forward, and every parameter and input gradient of
    sum(out * c), at depth 2 (rtol 1e-4, atol 1e-6, as stage B is held).
    The visual discriminator runs its ``object`` projection only at 512."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((L, B, width)).astype(np.float32)
    cot = rng.standard_normal((L, B, 1)).astype(np.float32)
    jm = jax_cls(D_h=100, num_layers=2)
    init_width = 512 if jax_cls is JaxVisualDiscriminator else 100
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((L, B, init_width)))["params"]

    def jax_fn(p, xx):
        out = jm.apply({"params": p}, xx, valid_len=VALID_LEN, deterministic=True)
        return jnp.sum(out * cot), out

    (_, want), (want_dp, want_dx) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    model = port_cls(D_h=100, num_layers=2, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt, valid_len=VALID_LEN)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-6)
    grads = state_dict_from_jax(want_dp)
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        got = named[k].grad
        if got is None:  # ``object`` at width 100: unused, so JAX's gradient is 0
            assert k.startswith("object.") and width == 100 and not g.any(), k
            continue
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_gan_state_dicts_from_jax_load_strict():
    """The six JAX networks of ``init_gan_state`` load into the port's six
    modules with ``strict=True``, value for value."""
    cfg = JG.GANConfig(num_layers=1, aot_cache=False)
    params = jax.tree.map(np.asarray, JG.init_gan_state(cfg, jax.random.PRNGKey(0))["params"])
    dicts = gan_state_dicts_from_jax(params)
    modules = TG.create_gan_modules(TG.GANConfig(num_layers=1), device="cpu")
    assert set(dicts) == set(modules) == set(TG.GEN_NAMES + TG.DISC_NAMES)
    for name, module in modules.items():
        module.load_state_dict(dicts[name], strict=True)
        for k, v in module.state_dict().items():
            assert torch.equal(v, dicts[name][k]), (name, k)
    assert "object.weight" in dicts["visual_disc"]


def _jax_deterministic_step(cfg):
    """The JAX 12-duel step with every net in eval mode, built from the JAX
    package's parts (``create_gan_modules``, ``DUEL_SCHEDULE``,
    ``_duel_mask``, ``bce_loss``, ``torch_adam`` with eps ``EPS``)."""
    modules = JG.create_gan_modules(cfg)
    lr = {"acoustic_gen": cfg.lr, "visual_gen": cfg.lr, "text_gen": cfg.lr * 1.1,
          **{n: cfg.lr / 2 for n in JG.DISC_NAMES}}
    opts = {n: jax_adam(lr[n], cfg.b1, cfg.b2, eps=EPS) for n in modules}
    real = {"acoustic": "audio", "visual": "visual", "text": "text"}

    def duel(i, net_params, opp_params, opt_state, batch):
        kind, net, net_mod, opp, opp_mod, _ = JG.DUEL_SCHEDULE[i]
        mask = JG._duel_mask(batch)

        def apply(name, p, x):
            return modules[name].apply({"params": p}, x, valid_len=batch["valid_len"],
                                       deterministic=True)

        if kind == "disc":
            def loss_fn(p):
                real_prob = apply(net, p, batch[real[net_mod]])
                fake = jax.lax.stop_gradient(apply(opp, opp_params, batch[real[opp_mod]]))
                fake_prob = apply(net, p, fake)
                return (jax_bce_loss(real_prob, jnp.ones_like(real_prob), mask)
                        + jax_bce_loss(fake_prob, jnp.zeros_like(fake_prob), mask)) / 2.0
        else:
            def loss_fn(p):
                prob = apply(opp, opp_params, apply(net, p, batch[real[net_mod]]))
                return jax_bce_loss(prob, jnp.ones_like(prob), mask)

        loss, grads = jax.value_and_grad(loss_fn)(net_params)
        updates, opt_state = opts[net].update(grads, opt_state, net_params)
        return optax.apply_updates(net_params, updates), opt_state, loss

    duels = [jax.jit(lambda a, b, c, d, i=i: duel(i, a, b, c, d)) for i in range(12)]

    def step(params, opt_state, batch):
        params, opt_state, losses = dict(params), dict(opt_state), []
        for i, (_, net, _, opp, _, _) in enumerate(JG.DUEL_SCHEDULE):
            params[net], opt_state[net], loss = duels[i](params[net], params[opp],
                                                         opt_state[net], batch)
            losses.append(float(loss))
        return params, opt_state, losses

    return step, {n: opts[n].init for n in modules}


def _port_state(num_layers, params, eps=EPS):
    """The port's six networks and Adams (eps ``eps``) from JAX params."""
    state = TG.init_gan_state(TG.GANConfig(num_layers=num_layers), device="cpu")
    for name, sd in gan_state_dicts_from_jax(params).items():
        state.modules[name].load_state_dict(sd, strict=True)
    for opt in state.opts.values():
        for group in opt.param_groups:
            group["eps"] = eps
    return state


def test_two_deterministic_gan_steps_match_jax():
    """Two deterministic 12-duel steps at depth 1 from the same weights and
    batch: all 12 duel losses (rtol 1e-5), and every parameter of the six
    nets after each step (atol 1e-6)."""
    cfg = JG.GANConfig(num_layers=1, aot_cache=False)
    params = jax.tree.map(np.asarray, JG.init_gan_state(cfg, jax.random.PRNGKey(5))["params"])
    jstep, jinit = _jax_deterministic_step(cfg)
    host, batch = _batch()
    jbatch = {**{k: jnp.asarray(v) for k, v in host.items()},
              "valid_len": jnp.asarray(VALID_LEN, jnp.int32), "n_real": jnp.asarray(N_REAL, jnp.int32)}
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = {n: jinit[n](jparams[n]) for n in jparams}

    state = _port_state(1, params)
    step = TG.make_gan_train_step(state.modules, state.opts, deterministic=True)
    for _ in range(2):
        jparams, jopt, want = jstep(jparams, jopt, jbatch)
        losses = step(batch)
        got = [losses[f"duel_{i}"].item() for i in range(12)]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for key in TG.LOGGED_LOSS_KEYS:  # each holds its last write
            last = max(i for i, d in enumerate(TG.DUEL_SCHEDULE) if d[5] == key)
            assert losses[key].item() == got[last]
        want_sd = gan_state_dicts_from_jax(jax.tree.map(np.asarray, jparams))
        for name, module in state.modules.items():
            for k, v in module.state_dict().items():
                np.testing.assert_allclose(v.numpy(), want_sd[name][k].numpy(), rtol=0,
                                           atol=1e-6, err_msg=f"{name}.{k}")


def test_gan_step_modes_and_updates():
    """A train-mode step: the disc duel runs the generator in eval mode
    without gradients and the discriminator in train mode; the gen duel runs
    the generator in train mode and the discriminator in eval mode.  Between
    two Adam steps only the stepped net's parameters, gradients and Adam
    state change, in schedule order; each net's Adam counts 2 steps."""
    state = TG.init_gan_state(TG.GANConfig(num_layers=1), device="cpu")
    events = []
    for name, module in state.modules.items():
        module.register_forward_pre_hook(
            lambda m, args, name=name: events.append((name, m.training, torch.is_grad_enabled())))

    def snapshot(name):
        """The net's parameters, gradients and Adam state."""
        module, opt = state.modules[name], state.opts[name]
        out = []
        for p in module.parameters():
            out += [p.detach().clone(), None if p.grad is None else p.grad.clone()]
            out += [v.clone() for v in opt.state.get(p, {}).values()]
        return out

    def same(a, b):
        return len(a) == len(b) and all(
            (x is None) == (y is None) and (x is None or torch.equal(x, y)) for x, y in zip(a, b))

    initial = {name: snapshot(name) for name in state.modules}
    before = dict(initial)
    for name, opt in state.opts.items():
        inner = opt.step

        def stepper(*args, name=name, inner=inner, **kw):
            events.append((name, "step"))
            for other in state.modules.keys() - {name}:
                assert same(snapshot(other), before[other]), f"{other} changed outside its step"
            out = inner(*args, **kw)
            before[name] = snapshot(name)
            return out

        opt.step = stepper

    losses = TG.make_gan_train_step(state.modules, state.opts)(_batch()[1])
    expected = []
    for kind, net, _, opp, _, _ in TG.DUEL_SCHEDULE:
        if kind == "disc":
            expected += [(net, True, True), (opp, False, False), (net, True, True)]
        else:
            expected += [(net, True, True), (opp, False, True)]
        expected.append((net, "step"))
    assert events == expected
    assert all(not same(snapshot(n), initial[n]) for n in state.modules)
    for name, module in state.modules.items():
        opt = state.opts[name]
        assert all(opt.state[p]["step"].item() == 2 for p in module.parameters()), name
    assert set(losses) == {f"duel_{i}" for i in range(12)} | set(TG.LOGGED_LOSS_KEYS)
    assert all(v.dim() == 0 and torch.isfinite(v) for v in losses.values())


def test_duel_mask_covers_the_padded_batch():
    """t < valid_len and b < n_real, not umask."""
    mask = TG.duel_mask(_batch()[1])
    assert mask.shape == (L, B, 1) and mask.dtype == torch.float32
    want = (np.arange(L)[:, None] < VALID_LEN) & (np.arange(B)[None, :] < N_REAL)
    np.testing.assert_array_equal(mask[..., 0].numpy(), want.astype(np.float32))


def test_gan_checkpoints_round_trip(tmp_path):
    """``save_gan_state`` then ``load_gan_state`` into fresh modules: the
    weights, and the Adam states unless ``reset_opt``."""
    cfg = TG.GANConfig(num_layers=1)
    state = TG.init_gan_state(cfg, device="cpu")
    TG.make_gan_train_step(state.modules, state.opts)(_batch()[1])
    save_gan_state(str(tmp_path), state)
    for reset in (False, True):
        fresh = TG.init_gan_state(TG.GANConfig(num_layers=1, seed=1), device="cpu")
        loaded = load_gan_state(str(tmp_path), *fresh, reset_opt=reset)
        for name, module in state.modules.items():
            for k, v in module.state_dict().items():
                assert torch.equal(loaded.modules[name].state_dict()[k], v), (name, k)
            opt_state = loaded.opts[name].state_dict()["state"]
            assert (opt_state == {}) == reset, name
            if not reset:
                want = state.opts[name].state_dict()["state"]
                assert all(torch.equal(opt_state[i]["exp_avg"], want[i]["exp_avg"]) for i in want)


def test_cli_runs_stage_a_and_resumes(tmp_path, monkeypatch):
    """``--GAN-epochs 1``: a 1-row GAN_loss.csv, six networks and their
    ``opt/`` twins; stage B starts from the saved generators.  Then
    ``--use-trained-GAN --continue-train-GAN-step 1`` extends the CSV to
    epoch 1 and stage B starts from the generators it saved."""
    data = write_synthetic_iemocap(str(tmp_path / "iemocap.pkl"), n_train=16, n_test=6,
                                   min_len=4, max_len=30, seed=0)
    save, out = tmp_path / "GAN_save", tmp_path / "output"
    first_models = []

    def capture(model, *args, **kw):
        first_models.append({k: v.clone() for k, v in model.state_dict().items()})
        return make_steps(model, *args, **kw)

    make_steps = CLI.make_classifier_steps
    monkeypatch.setattr(CLI, "make_classifier_steps", capture)
    common = ["--synthetic", "--data-path", data, "--epochs", "1", "--num-layers", "1",
              "--device", "cpu", "--output-dir", str(out), "--model-save-path", str(save)]
    for run, flags in enumerate((["--GAN-epochs", "1"],
                                 ["--use-trained-GAN", "--continue-train-GAN-step", "1"])):
        res = CLI.main(common + flags)
        assert np.isfinite(res["best_loss"])
        with open(out / "GAN_loss.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        assert [int(r["epoch"]) for r in rows] == list(range(run + 1))
        assert all(np.isfinite(float(v)) for r in rows for v in r.values())
        for name in TG.GEN_NAMES + TG.DISC_NAMES:
            assert (save / f"{name}.pt").is_file() and (save / "opt" / f"{name}.pt").is_file()
        for clf_key, gan_key in (("acoustic_generator", "acoustic_gen"),
                                 ("visual_generator", "visual_gen"),
                                 ("text_generator", "text_gen")):
            saved = torch.load(save / f"{gan_key}.pt", weights_only=True)
            for k, v in saved.items():
                assert torch.equal(first_models[run][f"{clf_key}.{k}"], v), (run, gan_key, k)


@pytest.mark.slow
def test_stage_a_loss_trajectory_band(iemocap_pickle):
    """15 epochs of stage A at depth 1 on the ``iemocap_pickle`` fixture, against the
    trajectory the JAX package recorded (tests/test_train.py,
    test_stage_a_loss_trajectory_band), within +-0.05, from the JAX
    package's initial weights at seed 3407: the recorded values are that
    init's trajectory (the JAX package misses its own band from the inits of
    other seeds, tests/stage_a_trajectory.py).  The two frameworks draw
    their dropout masks from different streams, so this holds train mode by
    distribution."""
    jax_cfg = JG.GANConfig(num_layers=1, aot_cache=False)
    params = jax.tree.map(np.asarray, JG.init_gan_state(jax_cfg, jax.random.PRNGKey(3407))["params"])
    state = _port_state(1, params, eps=1e-8)  # the default eps, as the JAX run
    train_loader, _, _ = get_iemocap_loaders(iemocap_pickle, batch_size=32, valid=0.1)
    torch.manual_seed(3407 + 1)
    _, history = train_gan(TG.GANConfig(num_layers=1), train_loader, 15, state=state,
                           device="cpu", log=lambda s: None, log_every_batch=False)
    expected = {
        5: {"acoustic_G_loss": 0.6322, "visual_G_loss": 0.5936, "text_G_loss": 0.6046,
            "visual_D_loss": 0.6895, "text_D_loss": 0.7056, "acoustic_D_loss": 0.7093},
        10: {"acoustic_G_loss": 0.6305, "visual_G_loss": 0.5857, "text_G_loss": 0.6132,
             "visual_D_loss": 0.6815, "text_D_loss": 0.7137, "acoustic_D_loss": 0.7144},
        15: {"acoustic_G_loss": 0.6201, "visual_G_loss": 0.5830, "text_G_loss": 0.6142,
             "visual_D_loss": 0.6751, "text_D_loss": 0.7142, "acoustic_D_loss": 0.7162},
    }
    for epoch, row in expected.items():
        for key, want in row.items():
            got = history[epoch - 1][key]
            assert abs(got - want) < 0.05, f"epoch {epoch} {key}: {got:.4f} against {want:.4f}"


@pytest.mark.slow
def test_full_pipeline_f1_band(tmp_path):
    """The whole pipeline (stage A, graft, stage B, best by test loss) with
    the arguments and band of the JAX package's
    tests/test_train.py::test_full_pipeline_f1_band."""
    fixture = write_synthetic_iemocap(
        str(tmp_path / "IEMOCAP_features.pkl"), n_train=120, n_test=31, min_len=6, max_len=24,
        class_spread=2.0, label_noise=0.25, seed=3407,
    )
    res = CLI.main([
        "--data-path", fixture, "--epochs", "30", "--GAN-epochs", "2",
        "--continue-train-GAN-step", "0", "--num-layers", "1",
        "--gan-schedule", "stepwise", "--batch-size", "32", "--lr", "0.0003",
        "--device", "cpu", "--output-dir", str(tmp_path / "output"),
        "--model-save-path", str(tmp_path / "GAN_save"),
    ])
    assert 72.0 <= res["f1"] <= 81.2, res
    assert 0.84 <= float(res["best_loss"]) <= 1.04, res
