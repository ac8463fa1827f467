"""The port's dropout stream (gan_ffn_tpu_torch.ops.dropout): the Philox
twin against exact Python-int arithmetic, the keep rule, the addressing of
the masks, their reuse in the backward, and train-mode outputs against the
JAX package's XLA dropout path by distribution (the two draw from different
generators, so no element-wise match is possible; tests/test_dropout_streams.py
compares streams the same way).

The CUDA kernels draw the same masks as this twin; tests/test_torch_kernels_cuda.py
and chip_smoke.py hold them to it element by element on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_ffn_tpu.models import AcousticGenerator as JaxAcoustic
from gan_ffn_tpu.nn.transformer import MultiheadSelfAttention as JaxAttention
from gan_ffn_tpu_torch.models import AcousticGenerator
from gan_ffn_tpu_torch.nn.core import set_dropout_generator
from gan_ffn_tpu_torch.nn.transformer import MultiheadSelfAttention
from gan_ffn_tpu_torch.ops import attention as TA
from gan_ffn_tpu_torch.ops import dropout as TD
from gan_ffn_tpu_torch.ops import mlp as TM
from gan_ffn_tpu_torch.utils.weights import gan_ffn_state_dict_from_jax

MASK32 = 0xFFFFFFFF


def philox_ints(counter, key):
    """Philox4x32-10 in Python ints (exact)."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & MASK32, p1 & MASK32,
             ((p0 >> 32) ^ c[3] ^ k[1]) & MASK32, p0 & MASK32]
        k = [(k[0] + 0x9E3779B9) & MASK32, (k[1] + 0xBB67AE85) & MASK32]
    return c


def test_python_philox_meets_the_published_answers():
    # Random123's known-answer vectors for philox4x32-10
    assert philox_ints([0, 0, 0, 0], [0, 0]) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert philox_ints([MASK32] * 4, [MASK32] * 2) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


@pytest.mark.parametrize("seed", [0, 1, 2**32 + 5, 2**63 - 2])
@pytest.mark.parametrize("stream", [TD.STREAM_ATTENTION, TD.STREAM_POST])
def test_twin_matches_python_ints(seed, stream):
    groups = [0, 1, 7, 2**31 + 3, 2**32 + 11, 2**40 + 1]
    counter = torch.tensor(groups, dtype=torch.int64)
    zero = torch.zeros_like(counter)
    got = TD.philox4x32((counter & MASK32, counter >> 32, zero + stream, zero),
                        (seed & MASK32, (seed >> 32) & MASK32))
    for i, g in enumerate(groups):
        want = philox_ints([g & MASK32, g >> 32, stream, 0], [seed & MASK32, seed >> 32])
        assert [int(w[i]) for w in got] == want
    # element idx takes word idx % 4 of counter group idx // 4
    bits = TD.random_bits(seed, stream, 30)
    for idx in (0, 3, 4, 29):
        want = philox_ints([idx // 4, 0, stream, 0], [seed & MASK32, seed >> 32])[idx % 4]
        assert int(bits[idx]) == want


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.6])
def test_keep_fraction_and_scale(rate):
    n = 1 << 20
    mask = TD.keep_scale(12345, TD.STREAM_MID, (n,), rate)
    assert mask.dtype == torch.float32
    values = set(mask.unique().tolist())
    assert values == {0.0, float(np.float32(1.0 / (1.0 - rate)))}
    kept = (mask > 0).double().mean().item()
    assert abs(kept - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
    threshold, scale = TD.threshold_and_scale(rate)
    assert threshold == int(rate * 2**32) and scale == 1.0 / (1.0 - rate)


def test_keep_rule_edges():
    assert TD.threshold_and_scale(0.0) == (0, 1.0)
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout rate"):
            TD.threshold_and_scale(bad)
    with pytest.raises(ValueError, match="dropout rate"):
        TA.fused_attention(*(torch.zeros(1, 1, 2, 4) for _ in range(3)), dropout_rate=1.0)


def test_masks_are_addressed_by_flat_index_only():
    a = TD.keep_scale(9, TD.STREAM_PRE, (6, 10), 0.5)
    b = TD.keep_scale(9, TD.STREAM_PRE, (60,), 0.5)
    c = TD.keep_scale(9, TD.STREAM_PRE, (100,), 0.5)
    torch.testing.assert_close(a.reshape(-1), b, rtol=0, atol=0)
    torch.testing.assert_close(b, c[:60], rtol=0, atol=0)
    assert not torch.equal(b, TD.keep_scale(9, TD.STREAM_MID, (60,), 0.5))
    assert not torch.equal(b, TD.keep_scale(10, TD.STREAM_PRE, (60,), 0.5))


def test_draw_seed_is_reproducible_and_host_only():
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    seeds = [TD.draw_seed(g1) for _ in range(3)]
    assert seeds == [TD.draw_seed(g2) for _ in range(3)]
    assert len(set(seeds)) == 3 and all(0 <= s < 2**63 for s in seeds)


def test_attention_backward_reuses_the_forward_mask():
    """The grad at rate > 0 is the grad of the plain chain with the same
    explicit mask (tolerance 1e-6: the same f32 arithmetic)."""
    rng = np.random.default_rng(3)
    leaves = [torch.from_numpy(rng.standard_normal((2, 4, 11, 6)).astype(np.float32))
              .requires_grad_() for _ in range(3)]
    dout = torch.from_numpy(rng.standard_normal((2, 4, 11, 6)).astype(np.float32))
    TA.fused_attention(*leaves, valid_len=9, dropout_rate=0.3, dropout_seed=77).backward(dout)
    mask = TD.keep_scale(77, TD.STREAM_ATTENTION, (2, 4, 11, 11), 0.3)
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    scores = (ref[0] @ ref[1].transpose(-1, -2)) / np.sqrt(6)
    scores = scores.masked_fill(torch.arange(11) >= 9, -1e30)
    ((torch.softmax(scores, -1) * mask) @ ref[2]).backward(dout)
    for t, r in zip(leaves, ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=1e-6, atol=1e-6)
    got = TA.fused_attention_backward(*(t.detach() for t in leaves), dout, 9, 0.3, 77)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r.grad, rtol=1e-6, atol=1e-6)


def test_mlp_backward_reuses_the_forward_masks():
    rng = np.random.default_rng(4)
    M, K, H, N = 12, 6, 10, 5
    shapes = ((M, K), (K, H), (H,), (H, N), (N,))
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
              for s in shapes]
    dout = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32))
    cfg = dict(pre=("gelu", 0.2), mid=("gelu", "drop_first", 0.2), post=("gelu", "drop_first", 0.2))
    TM.fused_mlp(*leaves, **cfg, dropout_seed=5).backward(dout)
    m_pre, m_mid, m_post = (TD.keep_scale(5, s, shape, 0.2) for s, shape in (
        (TD.STREAM_PRE, (M, K)), (TD.STREAM_MID, (M, H)), (TD.STREAM_POST, (M, N))))
    x, w1, b1, w2, b2 = ref = [t.detach().clone().requires_grad_() for t in leaves]
    gelu = torch.nn.functional.gelu
    out = gelu((gelu(((gelu(x) * m_pre) @ w1 + b1) * m_mid) @ w2 + b2) * m_post)
    out.backward(dout)
    for t, r in zip(leaves, ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=1e-5, atol=1e-6)


def _quartiles(a):
    return np.quantile(a, [0.25, 0.5, 0.75])


def _port_draws(module, x, n, valid_len):
    set_dropout_generator(module, torch.Generator().manual_seed(2))
    torch.manual_seed(3)
    module.train()
    with torch.no_grad():
        return np.array([float((module(x, valid_len=valid_len) ** 2).mean()) for _ in range(n)])


def _jax_draws(module, params, x, n, valid_len):
    def stat(key):
        out = module.apply({"params": params}, x, valid_len=jnp.int32(valid_len),
                           deterministic=False, rngs={"dropout": key})
        return (out ** 2).mean()

    return np.asarray(jax.jit(jax.vmap(stat))(jax.random.split(jax.random.PRNGKey(1), n)))


def test_generator_train_mode_matches_jax_by_distribution():
    """One-layer acoustic generator in training mode, fixed weights: the
    quartiles of mean(out**2) over 512 draws agree with the JAX XLA path
    within 2% (measured 0.4-0.6%).  PE dropout at 0.5 instead of 0.2 moves
    them by 20%, the head's rate at 0.3 instead of 0.2 by 30%."""
    n = 512
    x = np.random.default_rng(0).standard_normal((8, 2, 100)).astype(np.float32)
    jm = JaxAcoustic(D_h=100, num_layers=1)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = _quartiles(_jax_draws(jm, params, jnp.asarray(x), n, 6))
    port = AcousticGenerator(100, num_layers=1, device="cpu")
    port.load_state_dict(gan_ffn_state_dict_from_jax(params))
    got = _quartiles(_port_draws(port, torch.from_numpy(x), n, 6))
    np.testing.assert_allclose(got, want, rtol=0.02)
    port.net.position_encoding.dropout = 0.5
    wrong = _quartiles(_port_draws(port, torch.from_numpy(x), n, 6))
    assert np.all(np.abs(wrong / want - 1) > 0.1)


def test_attention_train_mode_matches_jax_by_distribution():
    """Self-attention with weight dropout 0.1 over 1024 draws against the JAX
    XLA path (nn.Dropout on the weights): quartiles of mean(out**2) within
    1% (measured 0.07%); rate 0.2 instead of 0.1 moves them by 9%."""
    n = 1024
    x = np.random.default_rng(1).standard_normal((16, 2, 100)).astype(np.float32)
    jm = JaxAttention(100, 10, dropout=0.1)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = _quartiles(_jax_draws(jm, params, jnp.asarray(x), n, 12))
    port = MultiheadSelfAttention(100, 10, 0.1, device="cpu")
    port.load_state_dict(gan_ffn_state_dict_from_jax(params))
    got = _quartiles(_port_draws(port, torch.from_numpy(x), n, 12))
    np.testing.assert_allclose(got, want, rtol=0.01)
    port.dropout = 0.2
    wrong = _quartiles(_port_draws(port, torch.from_numpy(x), n, 12))
    assert np.all(np.abs(wrong / want - 1) > 0.01)

