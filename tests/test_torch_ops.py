"""The port's kernel modules (gan_ffn_tpu_torch.ops) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode (the monkeypatch of
tests/test_pallas_ops.py) and its XLA chains.  Inputs are made by numpy from
a seed.  Tolerance rtol 2e-5, atol 2e-6, as the JAX kernels are held to
their XLA chains (tests/test_pallas_ops.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import gan_ffn_tpu.ops.attention as JA
import gan_ffn_tpu.ops.mlp as JM
from gan_ffn_tpu.ops.config import use_pallas_attention, use_pallas_mlp
from gan_ffn_tpu_torch.ops import attention as TA
from gan_ffn_tpu_torch.ops import mlp as TM

RTOL, ATOL = 2e-5, 2e-6
HEAD = dict(pre=("gelu", 0.0), mid=("gelu", "drop_first", 0.0), post=("gelu", "drop_first", 0.0))
FFN = dict(mid=("relu", "act_first", 0.0))


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas():
    """Run the JAX Pallas kernels in interpret mode on the CPU."""
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    mp = pytest.MonkeyPatch()
    JA._fwd_call.cache_clear()
    mp.setattr(JA.pl, "pallas_call", patched)
    mp.setattr(JM.pl, "pallas_call", patched)
    with use_pallas_attention(True), use_pallas_mlp(True):
        yield
    mp.undo()
    JA._fwd_call.cache_clear()


def _xla_attention(q, k, v, valid_len):
    Dh = q.shape[-1]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.float32(np.sqrt(Dh))
    pos = jnp.arange(q.shape[2])
    scores = jnp.where(pos < valid_len, scores, -1e30)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(scores, axis=-1), v)


@pytest.mark.parametrize("H,Dh", [(10, 10), (8, 64)])
@pytest.mark.parametrize("L", [5, 37, 112])
@pytest.mark.parametrize("valid", ["L", "L-3", "1", "0"])
def test_attention_plain_matches_jax(H, Dh, L, valid):
    vl = {"L": L, "L-3": L - 3, "1": 1, "0": 0}[valid]
    rng = np.random.default_rng(L * 10 + Dh)
    q, k, v = (rng.standard_normal((2, H, L, Dh)).astype(np.float32) for _ in range(3))
    got = TA.fused_attention(*(torch.from_numpy(t) for t in (q, k, v)), valid_len=vl).numpy()
    np.testing.assert_allclose(got, np.asarray(_xla_attention(q, k, v, vl)), rtol=RTOL, atol=ATOL)
    if vl > 0:
        # The Pallas kernel pads L to 128 lanes, so at valid_len = 0 it spreads
        # its uniform row over the padded keys too (out = mean(v) * L / 128):
        # the port follows the XLA chain there, and meets the kernel elsewhere.
        want = JA.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(vl))
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_attention_valid_len_zero_is_uniform():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 10)).astype(np.float32)) for _ in range(3))
    out = TA.fused_attention(q, k, v, valid_len=0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, v.mean(dim=2, keepdim=True).expand_as(v), rtol=1e-6, atol=1e-6)
    # an overlong valid_len is clamped to L
    torch.testing.assert_close(TA.fused_attention(q, k, v, valid_len=50), TA.fused_attention(q, k, v))


def _mlp_params(rng, K, H, N):
    """Weights at the scale of the model's own init, std ~ fan_in ** -0.5."""
    return (
        (rng.standard_normal((K, H)) * K ** -0.5).astype(np.float32),
        (rng.standard_normal((H,)) * 0.05).astype(np.float32),
        (rng.standard_normal((H, N)) * H ** -0.5).astype(np.float32),
        (rng.standard_normal((N,)) * 0.05).astype(np.float32),
    )


def _xla_mlp(x, w1, b1, w2, b2, cfg):
    if cfg is FFN:
        return jnp.maximum(x @ w1 + b1, 0.0) @ w2 + b2
    g = lambda t: jax.nn.gelu(t, approximate=False)
    return g(g(g(x) @ w1 + b1) @ w2 + b2)


@pytest.mark.parametrize(
    "K,H,N,cfg,pallas",
    [
        (100, 2048, 100, FFN, True),    # encoder FFN, d=100
        (100, 512, 100, HEAD, True),    # acoustic/text head
        (512, 1024, 100, HEAD, True),   # visual head
        (512, 2048, 512, FFN, False),   # visual FFN: JAX's TPU guard refuses it
    ],
)
def test_mlp_plain_matches_jax(K, H, N, cfg, pallas):
    rng = np.random.default_rng(K + H + N)
    x = rng.standard_normal((7, 3, K)).astype(np.float32)
    params = _mlp_params(rng, K, H, N)
    got = TM.fused_mlp(*(torch.from_numpy(t) for t in (x, *params)), **cfg).numpy()
    assert got.shape == (7, 3, N)
    np.testing.assert_allclose(got, np.asarray(_xla_mlp(x, *params, cfg)), rtol=RTOL, atol=ATOL)
    assert JM.fused_mlp_supported(K, H, N) == pallas
    if pallas:
        want = JM.fused_mlp(*(jnp.asarray(t) for t in (x, *params)), **cfg)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_mlp_supported_takes_every_serving_geometry():
    for K, H, N in ((100, 2048, 100), (512, 2048, 512), (100, 512, 100), (512, 1024, 100)):
        assert TM.fused_mlp_supported(K, H, N)
    assert not TM.fused_mlp_supported(100, 2048, 1024)  # accumulator columns
    assert not TM.fused_mlp_supported(4096, 2048, 512)  # shared memory


def test_dropout_waits_for_the_training_slice():
    t = torch.zeros(1, 1, 4, 8)
    with pytest.raises(NotImplementedError, match="training slice"):
        TA.fused_attention(t, t, t, dropout_rate=0.1)
    w1, w2 = torch.zeros(8, 16), torch.zeros(16, 8)
    with pytest.raises(NotImplementedError, match="training slice"):
        TM.fused_mlp(torch.zeros(2, 8), w1, torch.zeros(16), w2, torch.zeros(8),
                     mid=("relu", "act_first", 0.1))


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel or raises: a CUDA
    request without CUDA fails, and so does any other device."""
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TA.fused_attention(*(torch.zeros(1, 1, 4, 8, device="cuda") for _ in range(3)))
    meta = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        TA.fused_attention(meta, meta, meta)
    x, w1, w2 = (torch.zeros(s, device="meta") for s in ((2, 8), (8, 16), (16, 8)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        TM.fused_mlp(x, w1, torch.zeros(16, device="meta"), w2, torch.zeros(8, device="meta"))
