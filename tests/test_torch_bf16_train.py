"""The port's bf16 training (the bf16 backwards of ``ops.attention`` and
``ops.mlp``, ``bce_loss`` at bf16, stage A, stage B and the DialogueRNN at
``dtype=bfloat16``, ``--bf16`` in both trainers) against the JAX package.

On the CPU the kernel wrappers run their plain versions, which round where
the JAX kernels do at bf16.  Inputs are made by numpy from a seed and
rounded to bf16 once, so both sides see the same values.  The JAX side runs
its Pallas kernels in interpret mode where a test takes the
``interpret_pallas`` fixture (the ops, stage B and the DialogueRNN), else
its XLA paths (conftest sets ``GANFFN_PALLAS=0``; stage A, whose JAX
configuration takes XLA attention by default).  Limits:

- ops: max |diff| <= 2^-8 * max(1, max |ref|) per output (bf16's unit
  roundoff at the largest output) and at least 99% of the elements
  identical, as tests/test_torch_bf16.py holds the forwards; dW and db
  compared after their cast to the weights' dtype, as JAX returns them;
- ``bce_loss``: the same bf16 value, and every gradient within one bf16
  ulp of JAX's (2^-7 relative): both run the same ops at bf16;
- train steps: losses within 1e-2 relative (the JAX bf16 model bound,
  tests/test_serving.py:690), and each gradient within 5e-2 * max(1, max
  |ref|) of its own (the JAX ``--verify`` bound for bf16).  The worst of
  each is printed (``-s``);
- ``--bf16 --epoch-fused`` on one bucket: the per-batch bf16 loop's
  results bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

import gan_ffn_tpu.ops.attention as JA
import gan_ffn_tpu.ops.mlp as JM
from gan_ffn_tpu.cli.common import IEMOCAP_LOSS_WEIGHTS
from gan_ffn_tpu.models import GAN_FFN as JaxGAN_FFN
from gan_ffn_tpu.models import GAN_FFN_DialogueRNN as JaxGAN_FFN_DialogueRNN
from gan_ffn_tpu.nn.losses import bce_loss as jax_bce_loss
from gan_ffn_tpu.nn.losses import masked_nll_loss as jax_masked_nll_loss
from gan_ffn_tpu.ops.config import use_pallas_attention, use_pallas_mlp, use_stacked_bidir
from gan_ffn_tpu.train import gan as JG
from gan_ffn_tpu.train.loop import batch_to_arrays
from gan_ffn_tpu.train.optim import torch_adam as jax_adam
from gan_ffn_tpu_torch.cli import common as COMMON
from gan_ffn_tpu_torch.cli import train_iemocap_dialoguernn as DCLI
from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
from gan_ffn_tpu_torch.data.loaders import Batch
from gan_ffn_tpu_torch.models import GAN_FFN, GAN_FFN_DialogueRNN
from gan_ffn_tpu_torch.nn.core import set_dropout_generator
from gan_ffn_tpu_torch.nn.losses import bce_loss
from gan_ffn_tpu_torch.ops import attention as TA
from gan_ffn_tpu_torch.ops import mlp as TM
from gan_ffn_tpu_torch.train import gan as TG
from gan_ffn_tpu_torch.train.classifier import make_classifier_epoch_steps, make_classifier_steps
from gan_ffn_tpu_torch.utils.checkpoint import all_float32
from gan_ffn_tpu_torch.train.loop import batch_to_tensors, run_epoch, run_epoch_fused
from gan_ffn_tpu_torch.train.optim import torch_adam
from gan_ffn_tpu_torch.utils.weights import (gan_ffn_state_dict_from_jax, gan_state_dicts_from_jax,
                                             state_dict_from_jax)

BF16 = torch.bfloat16
BF16_TOL = 2.0 ** -8  # relative to max(1, max |ref|)
SAME = 0.99
LOSS_RTOL = 1e-2
GRAD_TOL = 5e-2  # relative to max(1, max |ref|) of each gradient
C = 6
HEAD = dict(pre=("gelu", 0.0), mid=("gelu", "drop_first", 0.0), post=("gelu", "drop_first", 0.0))
FFN = dict(mid=("relu", "act_first", 0.0))
REPO = Path(__file__).resolve().parents[1]
# Adam's eps is 1e-3 in both frameworks for the step comparisons, for the
# reason tests/test_torch_train.py gives (EPS)
EPS = 1e-3


@pytest.fixture
def interpret_pallas():
    """Run the JAX Pallas kernels in interpret mode on the CPU (the fixture
    of tests/test_torch_bf16.py), with the MLP guard's VMEM budget lifted so
    that the visual FFN runs through its kernel too."""
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    mp = pytest.MonkeyPatch()
    JA._fwd_call.cache_clear()
    JA._bwd_call.cache_clear()
    mp.setattr(JA.pl, "pallas_call", patched)
    mp.setattr(JM.pl, "pallas_call", patched)
    mp.setattr(JM, "_VMEM_BUDGET", 1 << 40)
    with use_pallas_attention(True), use_pallas_mlp(True):
        yield
    mp.undo()
    JA._fwd_call.cache_clear()
    JA._bwd_call.cache_clear()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the DialogueRNN's tiny ops run faster so, and
    the file does not oversubscribe the cores that the suite's workers
    share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(rng, shape, scale=1.0):
    """A bf16 tensor and the same values as a JAX bf16 array."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _close_bf16(got: torch.Tensor, want, what: str) -> None:
    assert got.dtype == BF16, what
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32).reshape(g.shape)
    tol = BF16_TOL * max(1.0, float(np.abs(w).max()))
    err = float(np.abs(g - w).max())
    same = float(np.mean(g == w))
    assert err <= tol and same >= SAME, (
        f"{what}: max |diff| {err} (limit {tol}), {same:.5f} identical (limit {SAME})")


def _grad_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |diff| / max(1, max |ref|)."""
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _close_grads(got: dict, want: dict, what: str) -> float:
    """Every gradient within GRAD_TOL of max(1, its max |ref|); returns the worst."""
    assert set(got) == set(want), what
    worst = 0.0
    for k, w in want.items():
        err = _grad_err(np.asarray(got[k], np.float32), np.asarray(w, np.float32))
        assert err <= GRAD_TOL, f"{what} {k}: {err} > {GRAD_TOL}"
        worst = max(worst, err)
    print(f"{what}: worst gradient error {worst:.3g} of max(1, max |ref|)")
    return worst


# ------------------------------------------------------------------ ops --


def _xla_attention_bf16(q, k, v, valid_len):
    """The JAX encoder's XLA attention at bf16 (nn/transformer.py)."""
    Dh = q.shape[-1]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    scores = scores * (1.0 / jnp.sqrt(jnp.asarray(Dh, jnp.float32)))
    pos = jnp.arange(q.shape[2])
    attn = jax.nn.softmax(jnp.where(pos < valid_len, scores, -1e30), axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", attn.astype(jnp.bfloat16), v,
                      preferred_element_type=jnp.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("H,Dh", [(10, 10), (8, 64)])
@pytest.mark.parametrize("valid", ["L", "partial", "1", "0"])
def test_attention_backward_matches_jax_bf16(interpret_pallas, H, Dh, valid):
    """dq, dk, dv against ``jax.vjp`` of the Pallas kernel at bf16; at
    valid_len 0 against the XLA chain's (the Pallas backward spreads its
    uniform row over 128 padded keys and does not zero the masked scores'
    gradient, ROADMAP "Facts")."""
    Lq = 37
    vl = {"L": Lq, "partial": 20, "1": 1, "0": 0}[valid]
    rng = np.random.default_rng(Dh + vl + 50)
    (q, jq), (k, jk), (v, jv), (do, jdo) = (_bf16(rng, (2, H, Lq, Dh)) for _ in range(4))
    got = TA.fused_attention_backward(q, k, v, do, vl)
    fn = ((lambda a, b, c: JA.fused_attention(a, b, c, jnp.int32(vl))) if vl > 0
          else (lambda a, b, c: _xla_attention_bf16(a, b, c, vl)))
    _, vjp = jax.vjp(fn, jq, jk, jv)
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jdo)):
        _close_bf16(g, w, f"{name} valid_len={vl}")
    # through autograd of fused_attention, the same bits
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    TA.fused_attention(*leaves, valid_len=vl).backward(do)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def _exact_dot_general(lhs, rhs, dimension_numbers, precision=None,
                       preferred_element_type=None):
    """``jax.lax.dot_general`` with the products' sum exact (f64 on the
    host), rounded once to the result dtype, as ``exact_matmul`` takes it."""
    (lc, rc), (lb, rb) = dimension_numbers
    names = iter("abcdefghijklmnop")
    ls = [next(names) for _ in range(lhs.ndim)]
    rs = [next(names) for _ in range(rhs.ndim)]
    for a, b in (*zip(lb, rb), *zip(lc, rc)):
        rs[b] = ls[a]
    out = ([ls[a] for a in lb] + [ls[i] for i in range(lhs.ndim) if i not in (*lb, *lc)]
           + [rs[i] for i in range(rhs.ndim) if i not in (*rb, *rc)])
    spec = f"{''.join(ls)},{''.join(rs)}->{''.join(out)}"
    dtype = np.dtype(preferred_element_type or lhs.dtype)
    shape = jax.eval_shape(lambda a, b: jnp.einsum(spec, a, b), lhs, rhs).shape
    return jax.pure_callback(
        lambda a, b: np.einsum(spec, np.asarray(a, np.float64),
                               np.asarray(b, np.float64)).astype(dtype),
        jax.ShapeDtypeStruct(shape, dtype), lhs, rhs)


def _torch_elementwise(fn):
    """An f32 elementwise function of the port, called from JAX."""
    def run(x):
        return jax.pure_callback(
            lambda a: fn(torch.from_numpy(np.array(a, np.float32))).numpy(),
            jax.ShapeDtypeStruct(x.shape, jnp.float32), x)
    return run


def port_arithmetic(monkeypatch):
    """The JAX MLP kernel at its own rounding points with the port's
    arithmetic between them: each product's sum exact, and the port's gelu
    and gelu' (torch's).  XLA's gelu and torch's differ in the last f32 bit
    of 31% of values; where that moves an a1 across a bf16 rounding
    boundary, every gradient of its row moves by a bf16 ulp (the head at 21
    rows: 98.2% of dx identical against the kernel's own arithmetic, all
    within the max |diff| limit)."""
    lax = type("lax", (), {**{k: getattr(jax.lax, k) for k in dir(jax.lax)
                              if not k.startswith("__")},
                           "dot_general": staticmethod(_exact_dot_general)})
    monkeypatch.setattr(JM, "jax", type("jax", (), {
        **{k: getattr(jax, k) for k in dir(jax) if not k.startswith("__")}, "lax": lax}))
    act, act_grad = JM._act, JM._act_grad
    gelu, dgelu = _torch_elementwise(torch.nn.functional.gelu), _torch_elementwise(
        lambda z: TM._act_grad("gelu", z))
    monkeypatch.setattr(JM, "_act", lambda name, x: gelu(x) if name == "gelu" else act(name, x))
    monkeypatch.setattr(JM, "_act_grad",
                        lambda name, z: dgelu(z) if name == "gelu" else act_grad(name, z))


@pytest.mark.parametrize("K,H,N,cfg", [
    (100, 2048, 100, FFN),   # encoder FFN, d=100
    (512, 2048, 512, FFN),   # visual FFN
    (100, 512, 100, HEAD),   # acoustic/text head
    (512, 1024, 100, HEAD),  # visual head
])
def test_mlp_backward_matches_jax_bf16(interpret_pallas, K, H, N, cfg, monkeypatch):
    """dx, dW1, db1, dW2, db2 against ``jax.vjp`` of the Pallas kernel at
    bf16, dW and db after the cast to the weights' dtype: within the max
    |diff| limit against the kernel as it is, and within both limits
    against it with the port's arithmetic between its rounding points
    (``port_arithmetic``)."""
    rng = np.random.default_rng(K + H + N + 1)
    x, jx = _bf16(rng, (21, K))
    (w1, jw1), (b1, jb1) = _bf16(rng, (K, H), K ** -0.5), _bf16(rng, (H,), 0.05)
    (w2, jw2), (b2, jb2) = _bf16(rng, (H, N), H ** -0.5), _bf16(rng, (N,), 0.05)
    do, jdo = _bf16(rng, (21, N))
    got = TM.fused_mlp_backward(x, w1, b1, w2, b2, do, **cfg)
    names = ("dx", "dw1", "db1", "dw2", "db2")

    def jax_grads():
        _, vjp = jax.vjp(lambda *a: JM.fused_mlp(*a, **cfg), jx, jw1, jb1, jw2, jb2)
        return vjp(jdo)

    for name, g, w in zip(names, got, jax_grads()):
        assert np.asarray(w).dtype == jnp.bfloat16, name
        w = np.asarray(w).astype(np.float32).reshape(g.shape)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= BF16_TOL * max(1.0, float(np.abs(w).max())), f"{name}: {err}"
    port_arithmetic(monkeypatch)
    for name, g, w in zip(names, got, jax_grads()):
        _close_bf16(g, w, f"{K}->{H}->{N} {name}, the port's arithmetic")
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    TM.fused_mlp(*leaves, **cfg).backward(do)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def test_bf16_plain_backwards_round_at_the_kernels_points():
    """The bf16 backwards written out: the attention's dropped weights and
    dS rounded to bf16 before their products, dP and D in f32; the MLP's g
    and dz1 rounded for their products while db1, db2 sum the f32 ones;
    every product's sum exact (f64), rounded to f32 once."""
    rng = np.random.default_rng(7)

    def exact(a, b):
        return (a.double() @ b.double()).float()

    (q, _), (k, _), (v, _), (do, _) = (_bf16(rng, (1, 2, 9, 16)) for _ in range(4))
    s = exact(q, k.transpose(-1, -2)) / 4.0
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.double().sum(-1, keepdim=True).float()
    keep = TA.keep_scale(5, TA.STREAM_ATTENTION, p.shape, 0.25, "cpu")
    dp = exact(do, v.transpose(-1, -2)) * keep
    D = (dp * p).double().sum(-1, keepdim=True).float()
    ds = (p * (dp - D) * 0.25).to(BF16)
    want = (exact(ds, k).to(BF16), exact(ds.transpose(-1, -2), q).to(BF16),
            exact((p * keep).to(BF16).transpose(-1, -2), do).to(BF16))
    for g, w in zip(TA.fused_attention_backward(q, k, v, do, 9, 0.25, 5), want):
        assert torch.equal(g, w)

    (x, _), (w1, _), (b1, _) = _bf16(rng, (6, 12)), _bf16(rng, (12, 20), 0.3), \
        _bf16(rng, (20,), 0.05)
    (w2, _), (b2, _), (dout, _) = _bf16(rng, (20, 8), 0.2), _bf16(rng, (8,), 0.05), \
        _bf16(rng, (6, 8))
    gelu = torch.nn.functional.gelu

    def dgelu(z):
        return 0.5 * (1.0 + torch.erf(z * 0.7071067811865476)) + z * (
            torch.exp(-0.5 * z * z) * 0.3989422804014327)

    xf = x.float()
    t1 = gelu(xf).to(BF16)
    z1 = exact(t1, w1) + b1.float()
    a1 = gelu(z1).to(BF16)
    z2 = exact(a1, w2) + b2.float()
    g = dout.float() * dgelu(z2)
    dz1 = exact(g.to(BF16), w2.t()) * dgelu(z1)
    want = ((exact(dz1.to(BF16), w1.t()) * dgelu(xf)).to(BF16),
            exact(t1.t(), dz1.to(BF16)).to(BF16), dz1.double().sum(0).float().to(BF16),
            exact(a1.t(), g.to(BF16)).to(BF16), g.double().sum(0).float().to(BF16))
    for name, got, w in zip(("dx", "dw1", "db1", "dw2", "db2"),
                            TM.fused_mlp_backward(x, w1, b1, w2, b2, dout, **HEAD), want):
        assert torch.equal(got, w), name


@pytest.mark.parametrize("target", [0.0, 1.0])
@pytest.mark.parametrize("masked", [False, True])
def test_bce_loss_matches_jax_bf16(target, masked):
    """Value and gradient at bf16 against the JAX ``bce_loss``, with
    predictions of exactly 0 and 1 in bf16 (the -100 clamp, and the
    gradient's 1e-12 floor)."""
    rng = np.random.default_rng(2)
    pred = (1 / (1 + np.exp(-2 * rng.standard_normal((16, 4, 1))))).astype(np.float32)
    pred[0, 0, 0], pred[1, 0, 0], pred[2, 1, 0], pred[3, 2, 0] = 0.0, 1.0, 0.0, 1.0
    p = torch.from_numpy(pred).to(BF16)
    jp = jnp.asarray(p.float().numpy(), jnp.bfloat16)
    mask = (np.arange(16)[:, None, None] < 12) & (np.arange(4)[None, :, None] < 3)
    mask = mask.astype(np.float32) if masked else None
    leaf = p.clone().requires_grad_()
    loss = bce_loss(leaf, torch.full_like(leaf, target),
                    None if mask is None else torch.from_numpy(mask))
    loss.backward()
    want, want_grad = jax.value_and_grad(
        lambda a: jax_bce_loss(a, jnp.full_like(a, target),
                               None if mask is None else jnp.asarray(mask)))(jp)
    assert loss.dtype == BF16 and np.asarray(want).dtype == jnp.bfloat16
    assert loss.float().item() == float(want)
    g, w = leaf.grad.float().numpy(), np.asarray(want_grad).astype(np.float32)
    assert np.isfinite(g).all() and leaf.grad.dtype == BF16
    np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=0)


# ---------------------------------------------------------------- steps --


@pytest.fixture(scope="module")
def stage_b_batches(tmp_path_factory):
    path = write_synthetic_iemocap(str(tmp_path_factory.mktemp("data") / "iemocap.pkl"),
                                   n_train=12, n_test=4, min_len=4, max_len=30, seed=3)
    train, _, _ = get_iemocap_loaders(path, batch_size=4, seed=3)
    return list(train)[:2]


def test_bf16_stage_b_step_matches_jax(interpret_pallas, stage_b_batches):
    """One deterministic bf16 train step of ``GAN_FFN`` (depth 1, B=4) from
    the JAX package's params: the loss (LOSS_RTOL) and every gradient
    (GRAD_TOL), then the params after two Adam steps (GRAD_TOL of the
    update, lr 1e-3)."""
    jm = JaxGAN_FFN(n_classes=C, gen_num_layers=1, dtype=jnp.bfloat16)
    arrays = [batch_to_arrays(b) for b in stage_b_batches]
    a = arrays[0]
    params = jm.init(jax.random.PRNGKey(0), a["audio"], a["visual"], a["text"])["params"]
    weights = jnp.asarray(IEMOCAP_LOSS_WEIGHTS)

    def jax_loss(p, arr):
        lp = jm.apply({"params": p}, arr["audio"], arr["visual"], arr["text"],
                      valid_len=arr["valid_len"], deterministic=True)[0]
        lp = lp.transpose(1, 0, 2).reshape(-1, C)
        return jax_masked_nll_loss(lp, arr["label"].reshape(-1), arr["umask"], weights)

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params, a)
    model = GAN_FFN(n_classes=C, gen_num_layers=1, device="cpu", dtype=BF16)
    model.load_state_dict(gan_ffn_state_dict_from_jax(params))
    opt = torch_adam(model.parameters(), 1e-3, eps=EPS, weight_decay=0.008)
    train_step, _ = make_classifier_steps(model, opt, C, torch.from_numpy(IEMOCAP_LOSS_WEIGHTS),
                                          deterministic=True)
    loss, _ = train_step(batch_to_tensors(stage_b_batches[0], "cpu"))
    rel = abs(loss.item() - float(want_loss)) / abs(float(want_loss))
    print(f"stage B: loss {loss.item()} against {float(want_loss)} ({rel:.3g} relative)")
    assert rel <= LOSS_RTOL
    named = dict(model.named_parameters())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in named.values())
    _close_grads({k: p.grad.numpy() for k, p in named.items()},
                 {k: v.numpy() for k, v in gan_ffn_state_dict_from_jax(want_grads).items()},
                 "stage B")


def _jax_gan_step_with_grads(cfg):
    """The JAX 12-duel step with every net in eval mode, from the JAX
    package's parts (tests/test_torch_gan.py's), also returning each duel's
    gradient."""
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
        return optax.apply_updates(net_params, updates), opt_state, loss, grads

    duels = [jax.jit(lambda a, b, c, d, i=i: duel(i, a, b, c, d)) for i in range(12)]

    def step(params, opt_state, batch):
        params, opt_state, losses, grads = dict(params), dict(opt_state), [], {}
        for i, (_, net, _, opp, _, _) in enumerate(JG.DUEL_SCHEDULE):
            params[net], opt_state[net], loss, grads[net] = duels[i](
                params[net], params[opp], opt_state[net], batch)
            losses.append(float(loss))
        return params, opt_state, losses, grads

    return step, {n: opts[n].init for n in modules}


def test_bf16_stage_a_step_matches_jax():
    """One deterministic bf16 12-duel step (depth 1, L=16, B=4, valid_len
    12, n_real 3) from the JAX package's params: the 12 duel losses
    (LOSS_RTOL) and each net's gradient of its last duel (GRAD_TOL)."""
    cfg = JG.GANConfig(num_layers=1, aot_cache=False, dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, JG.init_gan_state(cfg, jax.random.PRNGKey(5))["params"])
    jstep, jinit = _jax_gan_step_with_grads(cfg)
    rng = np.random.default_rng(0)
    host = {k: rng.standard_normal((16, 4, d)).astype(np.float32)
            for k, d in (("audio", 100), ("visual", 512), ("text", 100))}
    jbatch = {**{k: jnp.asarray(v) for k, v in host.items()},
              "valid_len": jnp.asarray(12, jnp.int32), "n_real": jnp.asarray(3, jnp.int32)}
    jparams = jax.tree.map(jnp.asarray, params)
    _, _, want, want_grads = jstep(jparams, {n: jinit[n](jparams[n]) for n in jparams}, jbatch)

    state = TG.init_gan_state(TG.GANConfig(num_layers=1, dtype=BF16), device="cpu")
    for name, sd in gan_state_dicts_from_jax(params).items():
        state.modules[name].load_state_dict(sd, strict=True)
    for opt in state.opts.values():
        for group in opt.param_groups:
            group["eps"] = EPS
    step = TG.make_gan_train_step(state.modules, state.opts, deterministic=True)
    losses = step({**{k: torch.from_numpy(v) for k, v in host.items()},
                   "valid_len": 12, "n_real": 3})
    got = np.array([losses[f"duel_{i}"].float().item() for i in range(12)])
    rel = np.abs(got - np.array(want)) / np.abs(np.array(want))
    print(f"stage A: worst duel loss {rel.max():.3g} relative")
    assert rel.max() <= LOSS_RTOL, (got, want)
    want_sd = gan_state_dicts_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, module in state.modules.items():
        named = dict(module.named_parameters())
        assert all(p.dtype == torch.float32 for p in named.values())
        _close_grads({k: p.grad.numpy() for k, p in named.items()},
                     {k: v.numpy() for k, v in want_sd[name].items()}, f"stage A {name}")


KW = dict(D_m=100, D_g=16, D_p=16, D_e=8, D_h=100, D_a=7, n_classes=C)


def _dialogue_batch(seed, length=16, lengths=(13, 9, 4, 0)):
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths)
    umask = (np.arange(length)[None, :] < lengths[:, None]).astype(np.float32)
    feats = {k: (rng.standard_normal((length, 4, d)) * umask.T[:, :, None]).astype(np.float32)
             for k, d in (("text", 100), ("audio", 100), ("visual", 512))}
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, umask.shape[::-1])]
    qmask = qmask * umask.T[:, :, None]
    label = (rng.integers(0, C, (4, length)) * umask).astype(np.int32)
    return Batch(feats["text"], feats["audio"], qmask, umask, label, ["a", "b", "c", "pad"],
                 feats["visual"], n_real=int((lengths > 0).sum()))


def test_bf16_dialoguernn_forward_and_step_match_jax(interpret_pallas):
    """``GAN_FFN_DialogueRNN`` at bf16 (depth 1, small recurrent widths,
    the context attention ``general``) from the JAX package's params: the
    log-probabilities and the attention weights within 1e-2, then one
    deterministic train step's loss (LOSS_RTOL) and every gradient
    (GRAD_TOL)."""
    batch = _dialogue_batch(10)
    arr = batch_to_arrays(batch)
    jm = JaxGAN_FFN_DialogueRNN(**KW, gen_num_layers=1, dtype=jnp.bfloat16)
    with use_stacked_bidir(False):
        params = jm.init(jax.random.PRNGKey(3), arr["audio"], arr["visual"], arr["text"],
                         arr["qmask"], arr["umask"])["params"]
    weights = jnp.asarray(IEMOCAP_LOSS_WEIGHTS)

    def apply(p):
        return jm.apply({"params": p}, arr["audio"], arr["visual"], arr["text"], arr["qmask"],
                        arr["umask"], valid_len=arr["valid_len"])

    def jax_loss(p):
        lp = apply(p)[0].transpose(1, 0, 2).reshape(-1, C)
        return jax_masked_nll_loss(lp, arr["label"].reshape(-1), arr["umask"], weights)

    model = GAN_FFN_DialogueRNN(**KW, gen_num_layers=1, device="cpu", dtype=BF16)
    model.load_state_dict(state_dict_from_jax(params))
    t = batch_to_tensors(batch, "cpu")
    with torch.no_grad():
        got = model.eval()(t["audio"], t["visual"], t["text"], t["qmask"], t["umask"],
                           valid_len=t["valid_len"])
    assert got[0].dtype == torch.float32
    for name, g, w in zip(("log_prob", "alpha", "alpha_f", "alpha_b"), got, apply(params)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=0,
                                   atol=1e-2, err_msg=name)

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    opt = torch_adam(model.parameters(), 1e-3, eps=EPS, weight_decay=1e-5)
    train_step, _ = make_classifier_steps(model, opt, C, torch.from_numpy(IEMOCAP_LOSS_WEIGHTS),
                                          deterministic=True)
    loss, _ = train_step(t)
    rel = abs(loss.item() - float(want_loss)) / abs(float(want_loss))
    print(f"DialogueRNN: loss {loss.item()} against {float(want_loss)} ({rel:.3g} relative)")
    assert rel <= LOSS_RTOL
    _close_grads({k: p.grad.numpy() for k, p in model.named_parameters()},
                 {k: v.numpy() for k, v in state_dict_from_jax(want_grads).items()},
                 "DialogueRNN")


# ------------------------------------------------------- epoch-fused --


ONE_BUCKET = dict(n_train=12, n_test=4, min_len=4, max_len=30)


def _pickle(tmp_path, seed, **kw):
    return write_synthetic_iemocap(str(tmp_path / f"iemocap_{seed}.pkl"), seed=seed, **kw)


def test_bf16_stage_a_one_bucket_fused_is_the_per_batch_loop(tmp_path):
    """On one bucket, with every dropout on, the fused bf16 stage-A epoch
    gives the per-batch bf16 loop's losses and parameters bit for bit."""
    pkl = _pickle(tmp_path, 7, **ONE_BUCKET)

    def run(fused):
        loader, _, _ = get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=7)
        torch.manual_seed(8)
        return COMMON.train_gan(TG.GANConfig(num_layers=1, seed=9, dtype=BF16), loader, 1,
                                device="cpu", log=lambda *_: None, epoch_fused=fused)

    (state_a, hist_a), (state_b, hist_b) = run(False), run(True)
    assert hist_a == hist_b and len(hist_a) == 1
    for name, module in state_a.modules.items():
        other = state_b.modules[name].state_dict()
        for k, v in module.state_dict().items():
            assert v.dtype == torch.float32 and torch.equal(v, other[k]), (name, k)


def test_bf16_stage_b_one_bucket_fused_is_the_per_batch_loop(tmp_path):
    """On one bucket, with every dropout on, a fused bf16 train epoch and an
    eval epoch give the per-batch bf16 loop's results and parameters bit
    for bit."""
    pkl = _pickle(tmp_path, 3, **ONE_BUCKET)

    def run(fused):
        train, valid, _ = get_iemocap_loaders(pkl, batch_size=4, valid=0.1, seed=3)
        model = GAN_FFN(n_classes=C, gen_num_layers=1, device="cpu", dtype=BF16,
                        generator=torch.Generator().manual_seed(1))
        set_dropout_generator(model, torch.Generator().manual_seed(2))
        opt = torch_adam(model.parameters(), 1e-3, weight_decay=0.008)
        make = make_classifier_epoch_steps if fused else make_classifier_steps
        train_step, eval_step = make(model, opt, C, torch.from_numpy(IEMOCAP_LOSS_WEIGHTS))
        epoch = run_epoch_fused if fused else run_epoch
        torch.manual_seed(4)
        return model, [epoch(train, train_step, "cpu"), epoch(valid, eval_step, "cpu")]

    (model_a, res_a), (model_b, res_b) = run(False), run(True)
    for a, b in zip(res_a, res_b):
        assert np.isfinite(a.avg_loss)
        assert (a.avg_loss, a.avg_accuracy, a.avg_fscore) == (b.avg_loss, b.avg_accuracy,
                                                              b.avg_fscore)
        for name in ("labels", "preds", "masks"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    other = model_b.state_dict()
    for k, v in model_a.state_dict().items():
        assert torch.equal(v, other[k]), k


# ----------------------------------------------------------------- CLIs --


def _cli(cwd, module, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", f"gan_ffn_tpu_torch.cli.{module}", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_flagship_cli_trains_bf16_on_the_cpu(tmp_path):
    """``--bf16``: stage A, the checkpoints, the graft and stage B run to
    the end; the report is written and every saved parameter is f32."""
    res = _cli(tmp_path, "train_iemocap", "--synthetic", "--bf16", "--GAN-epochs", "1",
               "--epochs", "1", "--num-layers", "1", "--device", "cpu",
               "--synthetic-train", "16", "--synthetic-test", "6")
    assert res.returncode == 0, res.stderr[-3000:]
    reports = list((tmp_path / "output").glob("test_out_GAN-epochs=1_F1-score=*.txt"))
    assert len(reports) == 1 and reports[0].read_text().startswith("Loss ")
    save = tmp_path / "GAN_save"
    for name in TG.GEN_NAMES + TG.DISC_NAMES:
        assert all_float32(save / f"{name}.msgpack"), name
    assert all_float32(save / "classifier_best.msgpack")


def test_dialoguernn_cli_trains_bf16_on_the_cpu(tmp_path):
    """``--bf16`` with ``--fresh-GAN``: stage A and the DialogueRNN's stage
    B run to the end; the best classifier's saved parameters are f32."""
    data = _pickle(tmp_path, 2, n_train=8, n_test=4, min_len=4, max_len=12)
    res = _cli(tmp_path, "train_iemocap_dialoguernn", "--bf16", "--data-path", data,
               "--fresh-GAN", "--GAN-epochs", "1", "--epochs", "1", "--num-layers", "1",
               "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Test performance" in res.stdout or "F1" in res.stdout
    assert all_float32(tmp_path / "GAN_save" / "acoustic_gen.msgpack")
    assert all_float32(tmp_path / "GAN_save" / "dialoguernn_classifier_best.msgpack")


def test_dialoguernn_cli_takes_the_flagship_stage_a_flags():
    """``--gan-schedule`` and ``--tb-grad-histograms``, as the flagship
    trainer takes them (the JAX DialogueRNN trainer's flags)."""
    args = DCLI.build_parser().parse_args(["--gan-schedule", "stepwise",
                                           "--tb-grad-histograms", "batch", "--bf16"])
    assert (args.gan_schedule, args.tb_grad_histograms, args.bf16) == ("stepwise", "batch", True)
    args = DCLI.build_parser().parse_args([])
    assert (args.gan_schedule, args.tb_grad_histograms, args.bf16) == ("fused", "epoch", False)
    assert not hasattr(COMMON, "LATER_FLAGS")  # the trainers refuse no flag as a later slice's
