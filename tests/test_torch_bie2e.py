"""The port's ``nn/recurrent.GRU``, ``models/dialogue_rnn.BiE2EModel`` and
the library-only losses of ``nn/losses.py`` against the JAX package's, on
the CPU.

Inputs come from numpy with a seed.  Forwards are held to rtol/atol 1e-5
and gradients to 1e-4 (the LSTM family's limits, tests/test_torch_meld.py);
the modules through ``tests/jax_parity.py::hold`` (one jitted JAX
``value_and_grad`` on the port's parameters, the weight bridge checked both
ways).  The file runs torch on one intra-op thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_parity import FWD_TOL, GRAD_TOL, _close, hold

from gan_ffn_tpu.models import BiE2EModel as JaxBiE2EModel
from gan_ffn_tpu.nn import losses as JL
from gan_ffn_tpu.nn.recurrent import GRU as JaxGRU
from gan_ffn_tpu_torch.models import BiE2EModel
from gan_ffn_tpu_torch.models import dialogue_rnn as DR
from gan_ffn_tpu_torch.nn import losses as PL
from gan_ffn_tpu_torch.nn.recurrent import GRU

B = 3
BIE2E = dict(D_emb=16, D_m=12, D_g=10, D_p=8, D_e=6, D_h=14, vocab_size=50, n_classes=7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _g(seed):
    return dict(generator=torch.Generator().manual_seed(seed), device="cpu")


def test_gru_matches_jax_and_torch():
    """Outputs and h_n, every parameter's gradient, and torch.nn.GRU on the
    same weights (its parameter names)."""
    x = np.random.default_rng(0).standard_normal((7, B, 12)).astype(np.float32)
    port = GRU(12, 8, **_g(0))
    outs, h_n = hold(port, JaxGRU(8), [x])
    assert outs.shape == (7, B, 8) and h_n.shape == (1, B, 8)
    hold(port, JaxGRU(8), [x], out_index=1, seed=3)  # h_n's gradient too
    ref = torch.nn.GRU(12, 8)
    ref.load_state_dict(port.state_dict())
    with torch.no_grad():
        want_out, want_h = ref(torch.from_numpy(x))
        got_out, got_h = port(torch.from_numpy(x))
    _close(got_out, want_out, FWD_TOL)
    _close(got_h, want_h, FWD_TOL)


def test_gru_takes_an_initial_state():
    rng = np.random.default_rng(1)
    x, h0 = rng.standard_normal((5, B, 6)).astype(np.float32), rng.standard_normal(
        (1, B, 4)).astype(np.float32)
    port = GRU(6, 4, **_g(1))
    ref = torch.nn.GRU(6, 4)
    ref.load_state_dict(port.state_dict())
    with torch.no_grad():
        got, want = port(torch.from_numpy(x), torch.from_numpy(h0)), ref(torch.from_numpy(x),
                                                                          torch.from_numpy(h0))
    for g, w in zip(got, want):
        _close(g, w, FWD_TOL)


def _turns(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, BIE2E["vocab_size"], (9, B)).astype(np.int64) for _ in range(3)]


@pytest.mark.parametrize("att2,context", [(False, "simple"), (True, "general2")])
def test_bie2e_model_matches_jax(att2, context):
    """The shared embedding and turn GRU, the fixed 3-utterance dialogue
    through both DialogueRNN directions, and the last utterance's head
    (MatchingAttention without a mask with att2)."""
    kw = dict(BIE2E, att2=att2, context_attention=context)
    port = BiE2EModel(**kw, **_g(2))
    (log_prob,) = hold(port, JaxBiE2EModel(**kw), _turns(3))
    assert log_prob.shape == (B, 7)
    np.testing.assert_allclose(np.exp(np.asarray(log_prob)).sum(-1), np.ones(B), rtol=1e-5)


def test_bie2e_dropout_sites(monkeypatch):
    """Training mode: the two post-scan dropouts at ``dropout`` (the forward
    emotions, then both directions' concatenation), not BiModel's dropout +
    0.15, and the scans' cell sites at ``dropout_rec``; eval mode: none."""
    calls = []
    dropout = DR.F.dropout

    def recording(x, p, training=True, *a, **k):
        calls.append((tuple(x.shape), p, training))
        return dropout(x, p, training, *a, **k)

    monkeypatch.setattr(DR.F, "dropout", recording)
    port = BiE2EModel(**BIE2E, dropout_rec=0.1, dropout=0.3, **_g(4))
    turns = [torch.from_numpy(t) for t in _turns(5)]
    torch.manual_seed(0)
    port.train()(*turns)
    post = [(s, p, t) for s, p, t in calls if p == 0.3]
    assert post == [((3, B, 6), 0.3, True), ((3, B, 12), 0.3, True)]
    assert {p for _, p, _ in calls} == {0.1, 0.3}
    calls.clear()
    port.eval()(*turns)
    assert all(not t for _, _, t in calls)


# the losses


def _log_probs(seed, N=20, C=6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, C)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    return (lp.astype(np.float32), rng.integers(0, C, N).astype(np.int64),
            (rng.random(N) > 0.3).astype(np.float32), rng.uniform(0.3, 1.5, C).astype(np.float32))


def _hold_loss(port_fn, jax_fn, x, *rest):
    """The loss and its gradient in ``x`` from both packages."""
    want, want_grad = jax.value_and_grad(lambda a: jax_fn(a, *(jnp.asarray(r) for r in rest)))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = port_fn(tx, *(torch.from_numpy(r) for r in rest))
    got.backward()
    _close(got.item(), float(want), FWD_TOL, "loss")
    _close(tx.grad, want_grad, GRAD_TOL, "gradient")


@pytest.mark.parametrize("weighted", [False, True])
def test_unmasked_weighted_nll_loss_matches_jax(weighted):
    lp, target, _, weight = _log_probs(6)
    rest = (target, weight) if weighted else (target,)
    _hold_loss(PL.unmasked_weighted_nll_loss, JL.unmasked_weighted_nll_loss, lp, *rest)


def test_masked_mse_loss_matches_jax():
    """The target is not masked: padded positions add their target's square."""
    rng = np.random.default_rng(7)
    pred, target = rng.standard_normal((2, 5, 4)).astype(np.float32)
    mask = (rng.random((5, 4)) > 0.4).astype(np.float32)
    _hold_loss(PL.masked_mse_loss, JL.masked_mse_loss, pred, target, mask)
    unmasked = float(((pred * mask - target) ** 2).sum() / mask.sum())
    got = PL.masked_mse_loss(*(torch.from_numpy(a) for a in (pred, target, mask))).item()
    assert got == pytest.approx(unmasked, rel=1e-6)


@pytest.mark.parametrize("weighted,gamma", [(False, 0.0), (False, 2.0), (True, 0.0), (True, 2.0)])
def test_focal_loss_matches_jax(weighted, gamma):
    """The double log-softmax, the mean over every row divided by
    sum(mask) (weighted: sum(w mask)), and the focal factor."""
    lp, target, mask, weight = _log_probs(8)

    def port(x, t, m, *w):
        return PL.focal_loss(x, t, m, *w, gamma=gamma)

    def ref(x, t, m, *w):
        return JL.focal_loss(x, t, m, *w, gamma=gamma)

    _hold_loss(port, ref, lp, target, mask, *((weight,) if weighted else ()))
