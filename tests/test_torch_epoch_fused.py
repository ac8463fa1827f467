"""The port's epoch-fused stages (``--epoch-fused``) against the JAX
package's, and against the port's own per-batch loops, on the CPU.

On the CPU the fused functions run the grouped epoch eagerly (no CUDA
graph).  The JAX side runs its XLA paths (conftest sets
``GANFFN_PALLAS=0``).  Depth 1, B = 4, one intra-op thread.  The two-bucket
fixtures have the sizes of ``tests/test_epoch_fused.py``'s and
``tests/test_epoch_fused_classifier.py``'s (12 training dialogues of 20-60
utterances), with seeds whose first epoch runs batches of L = 64, 32, 64:
two shapes, and groups that reorder the updates against loader order.
Tolerances are stated per test.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_ffn_tpu.cli.common import IEMOCAP_LOSS_WEIGHTS, make_gan_ffn_apply_fns
from gan_ffn_tpu.cli.common import resolve_epoch_fused_auto as jax_resolve_auto
from gan_ffn_tpu.cli.common import train_gan as jax_train_gan
from gan_ffn_tpu.data import get_iemocap_loaders as jax_loaders
from gan_ffn_tpu.models import GAN_FFN as JaxGAN_FFN
from gan_ffn_tpu.nn.losses import bce_loss as jax_bce_loss
from gan_ffn_tpu.train import gan as JG
from gan_ffn_tpu.train.classifier import init_classifier_state
from gan_ffn_tpu.train.classifier import make_classifier_epoch_steps as jax_epoch_steps
from gan_ffn_tpu.train.loop import batch_to_arrays
from gan_ffn_tpu.train.loop import run_epoch_fused as jax_run_epoch_fused
from gan_ffn_tpu.train.optim import torch_adam as jax_adam
from gan_ffn_tpu_torch.cli import common as COMMON
from gan_ffn_tpu_torch.cli import train_iemocap as CLI
from gan_ffn_tpu_torch.cli import train_iemocap_dialoguernn as DCLI
from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
from gan_ffn_tpu_torch.data.loaders import BucketedLoader
from gan_ffn_tpu_torch.models import GAN_FFN, GAN_FFN_DialogueRNN
from gan_ffn_tpu_torch.nn.core import set_dropout_generator
from gan_ffn_tpu_torch.ops import attention as A
from gan_ffn_tpu_torch.ops import dropout as D
from gan_ffn_tpu_torch.ops import mlp as M
from gan_ffn_tpu_torch.train import gan as TG
from gan_ffn_tpu_torch.train.classifier import make_classifier_epoch_steps, make_classifier_steps
from gan_ffn_tpu_torch.train.graphs import ShapeGraphs
from gan_ffn_tpu_torch.train.loop import batch_signature, fused_order, run_epoch, run_epoch_fused
from gan_ffn_tpu_torch.train.optim import set_lr_scale, torch_adam
from gan_ffn_tpu_torch.utils.weights import gan_ffn_state_dict_from_jax, gan_state_dicts_from_jax

C = 6
# Adam's eps is 1e-3 in both frameworks for the deterministic comparisons,
# for the reason tests/test_torch_train.py gives (EPS)
EPS = 1e-3
TWO_BUCKETS = dict(n_train=12, n_test=4, min_len=20, max_len=60)
ONE_BUCKET = dict(n_train=12, n_test=4, min_len=4, max_len=30)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pickle(tmp_path, seed, **kw):
    return write_synthetic_iemocap(str(tmp_path / f"iemocap_{seed}.pkl"), seed=seed, **kw)


def _shapes(loader):
    return [batch_signature(b) for b in loader]


# ---------------------------------------------------------------- stage A --


def _jax_deterministic_epoch_step(cfg, calls):
    """A JAX epoch step for ``train_gan(epoch_fused=True, step=...)``: the
    12-duel step with every net in eval mode (the JAX package's parts, as
    tests/test_torch_gan.py builds it), over each batch of a stacked group in
    turn.  Each batch's 12 losses go to ``calls``, keyed by its text's sum."""
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

    def epoch_step(state, stacked, keys):
        params, opt_state = dict(state["params"]), dict(state["opt"])
        rows = {k: [] for k in JG.LOGGED_LOSS_KEYS}
        for j in range(stacked["text"].shape[0]):
            batch = {k: v[j] for k, v in stacked.items()}
            losses = {}
            for i, (_, net, _, opp, _, key) in enumerate(JG.DUEL_SCHEDULE):
                params[net], opt_state[net], loss = duels[i](params[net], params[opp],
                                                             opt_state[net], batch)
                losses[f"duel_{i}"] = losses[key] = float(loss)
            calls.append((float(np.asarray(batch["text"]).sum()),
                           [losses[f"duel_{i}"] for i in range(12)]))
            for k in rows:
                rows[k].append(losses[k])
        return {"params": params, "opt": opt_state}, {k: np.asarray(v) for k, v in rows.items()}

    return epoch_step, opts


def _logged_rows(lines):
    return [[float(v) for v in re.findall(r"=(-?[\d.]+)", l)]
            for l in lines if re.match(r"GAN epoch \d+ acoustic_G_loss=", l)]


def test_train_gan_epoch_fused_matches_jax_on_two_buckets(tmp_path):
    """One deterministic fused stage-A epoch over two bucket shapes, from
    the JAX init: the same cross-group order of the steps, every batch's 12
    duel losses (rtol 1e-5), the logged rows in loader order (to their 4
    printed decimals), the CSV row, and every parameter after the epoch
    (atol 1e-6), as tests/test_torch_gan.py holds two steps."""
    pkl = _pickle(tmp_path, 76, **TWO_BUCKETS)

    def fresh():  # each loader reshuffles on every pass
        return get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=76)[0]

    shapes = _shapes(fresh())
    order = sorted(range(len(shapes)), key=lambda i: [s for s in dict.fromkeys(shapes)].index(
        shapes[i]))
    assert len(set(shapes)) == 2 and order != sorted(order), "the fixture must reorder"

    cfg = JG.GANConfig(num_layers=1, aot_cache=False)
    params = jax.tree.map(np.asarray, JG.init_gan_state(cfg, jax.random.PRNGKey(5))["params"])
    jax_calls, jax_lines = [], []
    jstep, opts = _jax_deterministic_epoch_step(cfg, jax_calls)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jparams, "opt": {n: opts[n].init(jparams[n]) for n in jparams}}
    jstate, jhistory = jax_train_gan(cfg, fresh(), 1, state=jstate, step=jstep,
                                     epoch_fused=True, log=jax_lines.append)

    state = TG.init_gan_state(TG.GANConfig(num_layers=1), device="cpu")
    for name, sd in gan_state_dicts_from_jax(params).items():
        state.modules[name].load_state_dict(sd, strict=True)
    for opt in state.opts.values():
        for group in opt.param_groups:
            group["eps"] = EPS
    inner = TG.make_gan_epoch_step(state.modules, state.opts, deterministic=True)
    calls, lines = [], []

    def step(batch):
        losses = inner(batch)
        calls.append((float(batch["text"].sum()), [losses[f"duel_{i}"].item() for i in range(12)]))
        return losses

    step.seeds = inner.seeds
    _, history = COMMON.train_gan(TG.GANConfig(num_layers=1), fresh(), 1, state=state,
                                  device="cpu", log=lines.append, epoch_fused=True, step=step)

    assert [c[0] for c in calls] == pytest.approx([c[0] for c in jax_calls], rel=1e-6)
    for (_, got), (_, want) in zip(calls, jax_calls):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    got_rows, want_rows = _logged_rows(lines), _logged_rows(jax_lines)
    assert len(got_rows) == len(want_rows) == len(shapes)
    np.testing.assert_allclose(got_rows, want_rows, rtol=0, atol=1.01e-4)
    assert len(history) == len(jhistory) == 1
    for k in TG.LOGGED_LOSS_KEYS:
        np.testing.assert_allclose(history[0][k], jhistory[0][k], rtol=1e-5)
    want_sd = gan_state_dicts_from_jax(jax.tree.map(np.asarray, jstate["params"]))
    for name, module in state.modules.items():
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want_sd[name][k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{name}.{k}")


def _gan_run(pkl, epoch_fused):
    loader, _, _ = get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=7)
    torch.manual_seed(8)
    state, history = COMMON.train_gan(TG.GANConfig(num_layers=1, seed=9), loader, 1,
                                      device="cpu", log=lambda *_: None, epoch_fused=epoch_fused)
    return state, history


def test_train_gan_one_bucket_fused_is_the_per_batch_loop(tmp_path):
    """On one bucket, with every dropout on, the fused stage-A epoch gives
    the per-batch loop's losses and parameters bit for bit: every batch
    draws the same kernel seeds and torch RNG draws."""
    pkl = _pickle(tmp_path, 7, **ONE_BUCKET)
    assert len(set(_shapes(get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=7)[0]))) == 1
    (state_a, hist_a), (state_b, hist_b) = _gan_run(pkl, False), _gan_run(pkl, True)
    assert hist_a == hist_b
    for name, module in state_a.modules.items():
        other = state_b.modules[name].state_dict()
        for k, v in module.state_dict().items():
            assert torch.equal(v, other[k]), (name, k)


# --------------------------------------------------------------- stage B --


def test_run_epoch_fused_matches_jax_on_two_buckets(tmp_path):
    """A deterministic fused stage-B train epoch over two bucket shapes
    against the JAX package's, from the same params: the loss (rtol 1e-5),
    predictions, labels and masks in loader order, and every parameter
    after the epoch (atol 1e-6)."""
    pkl = _pickle(tmp_path, 91, **TWO_BUCKETS)

    def fresh():
        return get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=91)[0]

    assert [b.seq_len for b in fresh()] == [64, 32, 64]
    jm = JaxGAN_FFN(n_classes=C, gen_num_layers=1)
    a = batch_to_arrays(next(iter(fresh())))
    params = jm.init(jax.random.PRNGKey(0), a["audio"], a["visual"], a["text"])["params"]
    _, apply_eval = make_gan_ffn_apply_fns(jm)
    jopt = jax_adam(1e-3, eps=EPS, weight_decay=0.008)
    jtrain, _ = jax_epoch_steps(lambda p, rng, b: apply_eval(p, b), apply_eval, jopt, C,
                                jnp.asarray(IEMOCAP_LOSS_WEIGHTS))
    jstate = init_classifier_state(jax.tree.map(jnp.copy, params), jopt)
    jstate, want = jax_run_epoch_fused(fresh(), jstate, train_epoch_step=jtrain,
                                       rng=jax.random.PRNGKey(4))

    model = GAN_FFN(n_classes=C, gen_num_layers=1, device="cpu")
    model.load_state_dict(gan_ffn_state_dict_from_jax(params))
    opt = torch_adam(model.parameters(), 1e-3, eps=EPS, weight_decay=0.008)
    train_step, _ = make_classifier_epoch_steps(model, opt, C,
                                                torch.from_numpy(IEMOCAP_LOSS_WEIGHTS),
                                                deterministic=True)
    got = run_epoch_fused(fresh(), train_step, "cpu")
    np.testing.assert_allclose(got.avg_loss, want.avg_loss, rtol=1e-5)
    for name in ("labels", "masks", "preds"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.labels, np.concatenate(
        [b.label.reshape(-1) for b in fresh()]))
    want_sd = gan_ffn_state_dict_from_jax(jax.tree.map(np.asarray, jstate["params"]))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def _stage_b_run(pkl, fused, lr_scale):
    train, valid, _ = get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=3)
    model = GAN_FFN(n_classes=C, gen_num_layers=1, generator=torch.Generator().manual_seed(1),
                    device="cpu")
    set_dropout_generator(model, torch.Generator().manual_seed(2))
    opt = torch_adam(model.parameters(), 1e-3, weight_decay=0.008)
    make = make_classifier_epoch_steps if fused else make_classifier_steps
    train_step, eval_step = make(model, opt, C, torch.from_numpy(IEMOCAP_LOSS_WEIGHTS))
    run = run_epoch_fused if fused else run_epoch
    torch.manual_seed(4)
    results = [run(train, train_step, "cpu", lr_scale=lr_scale) for _ in range(2)]
    results.append(run(valid, eval_step, "cpu"))
    return model, results


@pytest.mark.parametrize("lr_scale", [None, 0.5])
def test_run_epoch_one_bucket_fused_is_the_per_batch_loop(tmp_path, lr_scale):
    """On one bucket, with every dropout on, two fused train epochs and an
    eval epoch give the per-batch loop's results and parameters bit for
    bit: the seeds follow loader order."""
    pkl = _pickle(tmp_path, 3, **ONE_BUCKET)
    assert len(set(_shapes(get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=3)[0]))) == 1
    (model_a, res_a), (model_b, res_b) = (_stage_b_run(pkl, f, lr_scale) for f in (False, True))
    for a, b in zip(res_a, res_b):
        assert (a.avg_loss, a.avg_accuracy, a.avg_fscore) == (b.avg_loss, b.avg_accuracy,
                                                              b.avg_fscore)
        for name in ("labels", "preds", "masks"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    other = model_b.state_dict()
    for k, v in model_a.state_dict().items():
        assert torch.equal(v, other[k]), k


def test_dialoguernn_eval_attentions_fused_match_per_batch(tmp_path):
    """DialogueRNN eval epoch over two bucket shapes: the fused epoch's
    loss, predictions, vids and attention weights (each cut to its batch's
    n_real) equal the per-batch loop's, in loader order."""
    pkl = _pickle(tmp_path, 5, n_train=8, n_test=7, min_len=20, max_len=40)
    test = get_iemocap_loaders(pkl, batch_size=3, valid=0.1, seed=5)[2]
    assert len(set(_shapes(test))) == 2
    model = GAN_FFN_DialogueRNN(D_m=100, D_g=16, D_p=16, D_e=8, D_h=100, D_a=7, n_classes=C,
                                gen_num_layers=1, generator=torch.Generator().manual_seed(0),
                                device="cpu")
    opt = torch_adam(model.parameters(), 1e-3)
    _, eval_step = make_classifier_steps(model, opt, C)
    _, fused_eval = make_classifier_epoch_steps(model, opt, C)
    want, got = run_epoch(test, eval_step, "cpu"), run_epoch_fused(test, fused_eval, "cpu")
    assert got.avg_loss == want.avg_loss
    np.testing.assert_array_equal(got.preds, want.preds)
    assert got.attentions["vids"] == want.attentions["vids"] == [list(b.vids) for b in test]
    for key in ("alpha", "alpha_f", "alpha_b"):
        assert [a.shape for a in got.attentions[key]] == [
            (b.seq_len, b.n_real, b.seq_len) for b in test]
        for g, w in zip(got.attentions[key], want.attentions[key]):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------- kernels' new inputs --


def test_plain_versions_take_device_scalars_bit_for_bit():
    """valid_len as a 0-d int32 tensor and the seed as a SeedRef give the
    plain versions' host-int results bit for bit, forward and backward: the
    derived seed is ``derive_seed(base, k)``, and k < 0 takes the base."""
    rng = np.random.default_rng(0)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((2, 3, 11, 8)).astype(np.float32))
                     for _ in range(4))
    base = 0x1234_5678_9ABC_DEF
    ref = D.SeedRef(torch.tensor(base), 5)
    host = D.derive_seed(base, 5)
    assert 0 <= host < 2**63 and host == int(D.derive_seed(torch.tensor(base), 5))
    assert len({D.derive_seed(base, i) for i in range(64)}) == 64
    assert D.derive_seed(base, -1) == base
    for vl in (11, 7, 1, 0):
        tvl = torch.tensor(vl, dtype=torch.int32)
        got = A.fused_attention(q, k, v, valid_len=tvl, dropout_rate=0.3, dropout_seed=ref)
        want = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=0.3, dropout_seed=host)
        assert torch.equal(got, want), vl
        for g, w in zip(A.fused_attention_backward(q, k, v, dout, tvl, 0.3, ref),
                        A.fused_attention_backward(q, k, v, dout, vl, 0.3, host)):
            assert torch.equal(g, w), vl
    raw = D.SeedRef(torch.tensor(base), -1)
    assert torch.equal(A.attention_plain(q, k, v, 9, 0.3, raw), A.attention_plain(q, k, v, 9, 0.3, base))
    shapes = ((12, 6), (6, 10), (10,), (10, 5), (5,))
    x, w1, b1, w2, b2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                         for s in shapes)
    cfg = dict(pre=("gelu", 0.2), mid=("gelu", "drop_first", 0.2), post=("gelu", "drop_first", 0.2))
    assert torch.equal(M.fused_mlp(x, w1, b1, w2, b2, **cfg, dropout_seed=ref),
                       M.fused_mlp(x, w1, b1, w2, b2, **cfg, dropout_seed=host))
    mdout = torch.from_numpy(rng.standard_normal((12, 5)).astype(np.float32))
    for g, w in zip(M.fused_mlp_backward(x, w1, b1, w2, b2, mdout, **cfg, dropout_seed=ref),
                    M.fused_mlp_backward(x, w1, b1, w2, b2, mdout, **cfg, dropout_seed=host)):
        assert torch.equal(g, w)


def test_step_seeds_number_the_calls_of_a_step():
    """Inside a step the k-th call gets (base, k); outside one, each call a
    fresh host seed from the generator; steps drawn in a row from one
    generator are the per-batch loop's."""
    seeds = D.StepSeeds(torch.Generator().manual_seed(3))
    bases = [seeds.draw() for _ in range(3)]
    again = D.StepSeeds(torch.Generator().manual_seed(3))
    assert [int(again.draw_tensor("cpu")) for _ in range(3)] == bases
    base = torch.tensor(bases[0])
    with seeds.step(base):
        refs = [seeds.next() for _ in range(3)]
    assert [r.index for r in refs] == [0, 1, 2] and all(r.base is base for r in refs)
    assert isinstance(seeds.next(), int) and seeds.base is None
    model = GAN_FFN(gen_num_layers=1, device="cpu")
    shared = set_dropout_generator(model, torch.Generator())
    assert all(m.dropout_seeds is shared for m in model.modules() if hasattr(m, "dropout_seeds"))


def test_fused_order_groups_by_first_appearance_and_draws_in_loader_order(tmp_path):
    """The one policy both fused stages run: batches grouped by shape, the
    groups in order of first appearance, each in loader order; the seed
    bases drawn first, batch i's the i-th draw; none without a source."""
    pkl = _pickle(tmp_path, 91, **TWO_BUCKETS)
    batches = list(get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=91)[0])
    assert [b.seq_len for b in batches] == [64, 32, 64]
    shapes = _shapes(batches)
    order, bases = fused_order(batches, D.StepSeeds(torch.Generator().manual_seed(5)))
    firsts = list(dict.fromkeys(shapes))
    assert order == [i for shape in firsts for i, s in enumerate(shapes) if s == shape] == [0, 2, 1]
    draws = D.StepSeeds(torch.Generator().manual_seed(5))
    assert bases == [draws.draw() for _ in batches]
    assert fused_order(batches, None) == (order, [None] * len(batches))


def test_batch_carries_device_scalars_and_host_ints(tmp_path):
    pkl = _pickle(tmp_path, 6, **TWO_BUCKETS)
    batch = next(iter(get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=6)[2]))
    from gan_ffn_tpu_torch.train.loop import batch_to_tensors

    t = batch_to_tensors(batch, "cpu", seed=17)
    want_vl = int(batch.umask.sum(1).max())
    assert t["valid_len"].dtype == torch.int32 and t["valid_len"].dim() == 0
    assert int(t["valid_len"]) == t["host_valid_len"] == want_vl
    assert int(t["n_real"]) == t["host_n_real"] == batch.n_real
    assert t["seed"].dtype == torch.int64 and int(t["seed"]) == 17
    step_batch = {}
    ShapeGraphs(lambda b: step_batch.update(b), "eval")(t)
    assert "host_valid_len" not in step_batch and set(step_batch) <= set(t)


def test_tensor_lr_follows_the_float_schedule():
    """The lr in a tensor, decayed in place by ``set_lr_scale`` (how
    ``make_capturable`` hands it to an Adam on a card), against
    ``torch_adam``'s float lr
    over four epochs of the 0.98**e schedule: every parameter within 1e-7,
    the states' steps equal."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((5, 4)).astype(np.float32)
    grads = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(8)]
    a = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    b = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    float_opt = torch_adam([a], 1e-2, weight_decay=0.008)
    tensor_opt = torch.optim.Adam([b], lr=torch.tensor(1e-2), weight_decay=0.008)
    lr = tensor_opt.param_groups[0]["lr"]
    for e in range(4):
        set_lr_scale(float_opt, 0.98**e)
        set_lr_scale(tensor_opt, 0.98**e)
        assert tensor_opt.param_groups[0]["lr"] is lr
        for g in grads[2 * e:2 * e + 2]:
            a.grad, b.grad = torch.from_numpy(g), torch.from_numpy(g)
            float_opt.step()
            tensor_opt.step()
    np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=0, atol=1e-7)
    assert float_opt.param_groups[0]["lr"] == 1e-2 * 0.98**3
    assert int(tensor_opt.state[b]["step"]) == int(float_opt.state[a]["step"]) == 8


# ------------------------------------------------------------------ CLIs --


def test_flagship_cli_runs_epoch_fused_on_the_cpu(tmp_path):
    data = _pickle(tmp_path, 1, n_train=10, n_test=4, min_len=20, max_len=40)
    res = CLI.main(["--epoch-fused", "--device", "cpu", "--data-path", data, "--GAN-epochs", "1",
                    "--epochs", "1", "--num-layers", "1", "--output-dir", str(tmp_path / "out"),
                    "--model-save-path", str(tmp_path / "save"), "--lr-schedule", "decay"])
    assert np.isfinite(res["best_loss"]) and (tmp_path / "out" / "GAN_loss.csv").is_file()
    assert (tmp_path / "save" / "acoustic_gen.msgpack").is_file()


def test_dialoguernn_cli_runs_epoch_fused_on_the_cpu(tmp_path):
    data = _pickle(tmp_path, 2, n_train=8, n_test=4, min_len=4, max_len=12)
    res = DCLI.main(["--epoch-fused", "--device", "cpu", "--data-path", data, "--fresh-GAN",
                     "--GAN-epochs", "1", "--epochs", "1", "--num-layers", "1",
                     "--output-dir", str(tmp_path / "out"),
                     "--model-save-path", str(tmp_path / "save")])
    assert np.isfinite(res["best_loss"]) and res["attentions"]["alpha"]


def test_epoch_fused_refuses_the_stepwise_schedule(capsys):
    with pytest.raises(SystemExit):
        CLI.main(["--epoch-fused", "--gan-schedule", "stepwise", "--device", "cpu"])
    assert "--gan-schedule stepwise" in capsys.readouterr().err
    assert not hasattr(COMMON, "LATER_FLAGS")  # the trainers refuse no flag as a later slice's


@pytest.mark.parametrize("lengths,fused", [(ONE_BUCKET, True), (TWO_BUCKETS, False)])
def test_resolve_epoch_fused_auto_agrees_with_jax(tmp_path, lengths, fused):
    pkl = _pickle(tmp_path, 4, **lengths)
    ours = get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=4)[0]
    theirs = jax_loaders(pkl, batch_size=4, valid=0.1, seed=4)[0]
    assert COMMON.resolve_epoch_fused_auto(ours) == jax_resolve_auto(theirs) == fused


def test_resolve_epoch_fused_auto_raises_past_the_largest_bucket(tmp_path):
    """A dialogue longer than the largest bucket: the port's AUTO raises as
    its loader does; the JAX AUTO clamps it into that bucket and says fused."""
    pkl = _pickle(tmp_path, 8, n_train=6, n_test=2, min_len=20, max_len=30)
    ours = get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=8)[0]
    theirs = jax_loaders(pkl, batch_size=4, valid=0.1, seed=8)[0]
    short = BucketedLoader(ours.dataset, ours.indices, 4, buckets=(24,))
    assert max(ours.dataset[int(i)].length for i in ours.indices) > 24
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        COMMON.resolve_epoch_fused_auto(short)
    theirs.buckets = (24,)
    assert jax_resolve_auto(theirs) is True
