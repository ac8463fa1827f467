"""The port's kernel modules (gan_ffn_tpu_torch.ops) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions, and their
backward is autograd of those; the JAX side runs its Pallas kernels in
interpret mode (the monkeypatch of tests/test_pallas_ops.py), forward and
custom-VJP backward, and its XLA chains.  Inputs are made by numpy from a
seed.  Forward tolerance rtol 2e-5, atol 2e-6, as the JAX kernels are held
to their XLA chains (tests/test_pallas_ops.py); backward rtol 1e-4, atol
1e-5, for f32 gradient products summed in another order.
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
from gan_ffn_tpu_torch.ops import dropout as TD
from gan_ffn_tpu_torch.ops import mlp as TM

RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
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
    JA._bwd_call.cache_clear()
    mp.setattr(JA.pl, "pallas_call", patched)
    mp.setattr(JM.pl, "pallas_call", patched)
    with use_pallas_attention(True), use_pallas_mlp(True):
        yield
    mp.undo()
    JA._fwd_call.cache_clear()
    JA._bwd_call.cache_clear()


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
    # the tiled kernels hold no (rows, N) accumulator and stage fixed tiles:
    # any width fits, and only the int flat indices and the grid's rows bound them
    assert TM.fused_mlp_supported(100, 2048, 1024) and TM.fused_mlp_supported(4096, 2048, 512)
    assert TM.fused_mlp_supported(512, 2048, 512, 3584)
    assert not TM.fused_mlp_supported(512, 2048, 512, 2**31 // 2048)  # flat index of (M, H)
    assert not TM.fused_mlp_supported(1, 1, 1, 65535 * 64 + 1)  # row tiles past the grid
    assert not TM.fused_mlp_supported(0, 2048, 100)


def test_attention_dropout_applies_the_twin_mask():
    """At rate > 0 the weights are multiplied by ops.dropout's mask of
    stream STREAM_ATTENTION over (B, H, L, L); a rate of 0 ignores the seed."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 9, 8)).astype(np.float32))
               for _ in range(3))
    got = TA.fused_attention(q, k, v, valid_len=7, dropout_rate=0.25, dropout_seed=42)
    scores = (q @ k.transpose(-1, -2)) / np.sqrt(8)
    scores = scores.masked_fill(torch.arange(9) >= 7, -1e30)
    mask = TD.keep_scale(42, TD.STREAM_ATTENTION, (2, 3, 9, 9), 0.25)
    assert set(mask.unique().tolist()) == {0.0, np.float32(1 / 0.75)}
    torch.testing.assert_close(got, (torch.softmax(scores, -1) * mask) @ v, rtol=1e-6, atol=1e-6)
    assert not torch.equal(got, TA.fused_attention(q, k, v, 7, 0.25, 43))
    torch.testing.assert_close(TA.fused_attention(q, k, v, 7, 0.0, 42), TA.fused_attention(q, k, v, 7))


@pytest.mark.parametrize("order", ["drop_first", "act_first"])
def test_mlp_dropout_applies_the_twin_masks(order):
    """pre is act then dropout, mid follows its order, post is act(dropout(z));
    each mask is its stream's over the (M, K), (M, H) or (M, N) tensor."""
    rng = np.random.default_rng(6)
    M, K, H, N = 10, 8, 16, 4
    x = torch.from_numpy(rng.standard_normal((2, 5, K)).astype(np.float32))
    w1, b1, w2, b2 = (torch.from_numpy(t) for t in _mlp_params(rng, K, H, N))
    cfg = dict(pre=("gelu", 0.1), mid=("relu", order, 0.2), post=("gelu", "drop_first", 0.3))
    got = TM.fused_mlp(x, w1, b1, w2, b2, **cfg, dropout_seed=7)
    gelu = torch.nn.functional.gelu
    m_pre, m_mid, m_post = (TD.keep_scale(7, s, shape, r) for s, shape, r in (
        (TD.STREAM_PRE, (M, K), 0.1), (TD.STREAM_MID, (M, H), 0.2), (TD.STREAM_POST, (M, N), 0.3)))
    z1 = (gelu(x.reshape(M, K)) * m_pre) @ w1 + b1
    a1 = torch.relu(z1 * m_mid) if order == "drop_first" else torch.relu(z1) * m_mid
    want = gelu((a1 @ w2 + b2) * m_post).reshape(2, 5, N)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert not torch.equal(got, TM.fused_mlp(x, w1, b1, w2, b2, **cfg, dropout_seed=8))


def _xla_attention_vjp(q, k, v, vl, dout):
    _, vjp = jax.vjp(lambda *a: _xla_attention(*a, vl), q, k, v)
    return vjp(dout)


@pytest.mark.parametrize("H,Dh", [(10, 10), (8, 64)])
@pytest.mark.parametrize("L", [37, 112])
@pytest.mark.parametrize("valid", ["L", "L-3", "1", "0"])
def test_attention_backward_plain_matches_jax(H, Dh, L, valid):
    """The plain backward against the vjp of the Pallas kernels (forward and
    backward in interpret mode); at valid_len = 0 against the XLA chain,
    where the Pallas backward differs (ROADMAP Queue 3): dQ = dK = 0."""
    vl = {"L": L, "L-3": L - 3, "1": 1, "0": 0}[valid]
    rng = np.random.default_rng(L * 7 + Dh)
    q, k, v, dout = (rng.standard_normal((2, H, L, Dh)).astype(np.float32) for _ in range(4))
    got = TA.fused_attention_backward(*(torch.from_numpy(t) for t in (q, k, v, dout)), vl)
    if vl > 0:
        _, vjp = jax.vjp(lambda *a: JA.fused_attention(*a, jnp.int32(vl)), q, k, v)
        want = vjp(jnp.asarray(dout))
    else:
        want = _xla_attention_vjp(q, k, v, vl, dout)
        assert not got[0].any() and not got[1].any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _xla_mlp_vjp(x, params, cfg, dout):
    _, vjp = jax.vjp(lambda *a: _xla_mlp(*a, cfg), x, *params)
    return vjp(dout)


@pytest.mark.parametrize(
    "K,H,N,cfg,pallas",
    [
        (100, 2048, 100, FFN, True),
        (100, 512, 100, HEAD, True),
        (512, 1024, 100, HEAD, True),
        (512, 2048, 512, FFN, False),  # the TPU guard refuses it: the XLA chain
    ],
)
def test_mlp_backward_plain_matches_jax(K, H, N, cfg, pallas):
    rng = np.random.default_rng(K + H + N + 1)
    x = rng.standard_normal((21, K)).astype(np.float32)
    params = _mlp_params(rng, K, H, N)
    dout = rng.standard_normal((21, N)).astype(np.float32)
    got = TM.fused_mlp_backward(*(torch.from_numpy(t) for t in (x, *params, dout)), **cfg)
    if pallas:
        _, vjp = jax.vjp(lambda *a: JM.fused_mlp(*a, **cfg), x, *params)
        want = vjp(jnp.asarray(dout))
    else:
        want = _xla_mlp_vjp(x, params, cfg, dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_mlp_backward_guard_takes_every_path_geometry():
    for K, H, N in ((100, 2048, 100), (512, 2048, 512), (100, 512, 100), (512, 1024, 100)):
        assert TM.fused_mlp_supported(K, H, N, 3584)
    assert not TM.fused_mlp_supported(512, 2048, 512, 2**21)  # flat indices >= 2**31
    rows = TM.GRID_Y_LIMIT * 64  # the grid's row tiles
    assert TM.fused_mlp_supported(1, 1, 1, rows - 1)
    assert not TM.fused_mlp_supported(1, 1, 1, rows)
    assert not TM.fused_mlp_supported(2**20, 2048, 1)  # the flat index of (K + 1, H)


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


def test_build_keeps_each_librarys_ptxas_log(tmp_path, monkeypatch):
    """build() writes the compiler's output beside each library it makes
    and, for a library built earlier, reads it back into build_logs, so
    chip_smoke.py reports registers and spills of a cached library too."""
    import stat

    from gan_ffn_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"  # writes its -o target and prints a ptxas line
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
                    "echo binary > \"$out\"\n"
                    "echo \"ptxas info    : Compiling entry function 'k_kernel' for 'sm_90a'\"\n"
                    "echo \"ptxas info    : Function properties for k_kernel\"\n"
                    "echo \"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\"\n"
                    "echo \"ptxas info    : Used 72 registers, used 1 barriers\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    csrc, build_dir = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("int f();\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    lib = _build.build(["k"])["k"]
    assert lib.read_text() == "binary\n" and lib.with_suffix(".log").exists()
    assert _build.ptxas_resources(_build.build_logs["k"]) == [
        {"kernel": "k_kernel", "registers": 72, "spill_stores": 0, "spill_loads": 0}]
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("a built library was compiled again"))
    assert _build.build(["k"])["k"] == lib
    assert "Used 72 registers" in _build.build_logs["k"]


def test_library_path_follows_the_included_headers(tmp_path):
    """A kernel library's name covers its source, every header it includes
    from csrc (directly or through another header) and the flags: editing an
    included header rebuilds, editing one it does not include does not."""
    from gan_ffn_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "unused.cuh").write_text("// unused\n")
    src = tmp_path / "k.cu"
    assert [h.name for h in _build.local_headers(src)] == ["a.cuh", "b.cuh"]
    first = _build._library_path(src)
    (tmp_path / "unused.cuh").write_text("// edited\n")
    assert _build._library_path(src) == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build._library_path(src) != first
    # every kernel of the port's model that drops out includes the Philox
    # header (the trace stamp, utils/profiling.py, and the GRU gates,
    # ops/gru.py, draw nothing)
    assert all(any(h.name == "philox.cuh" for h in _build.local_headers(p))
               for name, p in _build.sources().items()
               if name not in ("trace_stamp", "gru_gates"))
    assert set(_build.sources()) == {"attention_fwd", "attention_bwd", "mlp_fwd", "mlp_bwd",
                                     "attention_fwd_bf16", "mlp_fwd_bf16",
                                     "attention_bwd_bf16", "mlp_bwd_bf16", "trace_stamp",
                                     "gru_gates", "moe_ffn"}
    # the bf16 kernels follow their tensor-core header too, and each bf16
    # backward the header of the code it shares with its forward
    for name, shared in (("attention_fwd_bf16", "attention_bf16.cuh"),
                         ("attention_bwd_bf16", "attention_bf16.cuh"),
                         ("mlp_fwd_bf16", "mlp_bf16_tile.cuh"),
                         ("mlp_bwd_bf16", "mlp_bf16_tile.cuh")):
        headers = [h.name for h in _build.local_headers(_build.sources()[name])]
        assert "mma_bf16.cuh" in headers and shared in headers, name
