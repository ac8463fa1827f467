"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda_hardware``: every test skips where ``torch.cuda.is_available()``
is False (the CPU gate), and runs the hand-written kernels wherever a CUDA
card is present:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Shapes cover the path's geometries at small batch plus ragged edges (L and
M not multiples of the kernels' tiles; for attention, L on both sides of the
16-row warp tiles and of the 4-element Philox groups, Dh on both sides of
the 16 / 32 / 64 head widths), at dropout rate 0 and above it: the
kernels draw the same Philox masks as the plain versions, so the two are
compared element by element at any rate.  Tolerances: attention forward max
|diff| <= 1e-5 (one softmax over <= 128 keys in f32); attention backward
and both MLP kernels max |diff| <= 1e-4 * max(1, max |ref|) (sums of f32
products in another order, and erff against torch's erf).  The backward
kernels sum in a fixed order, so two calls give identical bits.
"""

import numpy as np
import pytest
import torch

from gan_ffn_tpu_torch.ops import attention as A
from gan_ffn_tpu_torch.ops import mlp as M

pytestmark = pytest.mark.cuda_hardware

HEAD = dict(pre=("gelu", 0.0), mid=("gelu", "drop_first", 0.0), post=("gelu", "drop_first", 0.0))
FFN = dict(mid=("relu", "act_first", 0.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, scale, device):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)


# Head widths on both sides of the kernels' 16 / 32 / 64 widths and lengths on
# both sides of the 16-row warp tiles and the 4-element Philox groups.
ATTN_HEADS = [(10, 10), (8, 64), (3, 7), (2, 16), (2, 33)]
ATTN_LENGTHS = [1, 15, 16, 17, 37, 112, 128]


def _valid_lens(L):
    return sorted({L, max(L - 3, 0), min(16, L), 1, 0})


@pytest.mark.parametrize("H,Dh", ATTN_HEADS)
@pytest.mark.parametrize("L", ATTN_LENGTHS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernel_matches_plain(cuda, H, Dh, L, rate):
    rng = np.random.default_rng(L * 100 + Dh)
    q, k, v = (_randn(rng, (3, H, L, Dh), 1.0, cuda) for _ in range(3))
    for vl in _valid_lens(L):
        before = A.fused_attention.launches
        got = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=vl + 3)
        torch.cuda.synchronize()
        assert A.fused_attention.launches == before + 1
        want = A.attention_plain(q, k, v, vl, rate, vl + 3)
        err = (got - want).abs().max().item()
        assert err <= 1e-5, f"valid_len={vl}: max |diff| {err}"


def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 129, 8, device=cuda)
    with pytest.raises(ValueError, match="L <= 128"):
        A.fused_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        A.fused_attention(q, q, q)


@pytest.mark.parametrize(
    "K,H,N,cfg",
    [
        (100, 2048, 100, FFN),
        (512, 2048, 512, FFN),
        (100, 512, 100, HEAD),
        (512, 1024, 100, HEAD),
        (37, 100, 33, HEAD),  # ragged everywhere: 4-byte weight copies
        (64, 130, 260, FFN),  # H % 4 != 0: 4-byte copies, 3 column groups
        (100, 300, 200, HEAD),  # 16-byte copies, a partial d_ff chunk, 2 column groups
    ],
)
@pytest.mark.parametrize("rows", [1, 77, 3584])
def test_mlp_kernel_matches_plain(cuda, K, H, N, cfg, rows):
    rng = np.random.default_rng(K + H + N + rows)
    x = _randn(rng, (rows, K), 1.0, cuda)
    w1 = _randn(rng, (K, H), K ** -0.5, cuda)
    b1 = _randn(rng, (H,), 0.05, cuda)
    w2 = _randn(rng, (H, N), H ** -0.5, cuda)
    b2 = _randn(rng, (N,), 0.05, cuda)
    before = M.fused_mlp.launches
    got = M.fused_mlp(x, w1, b1, w2, b2, **cfg)
    torch.cuda.synchronize()
    assert M.fused_mlp.launches == before + 1
    want = M.mlp_plain(x, w1, b1, w2, b2, **cfg)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, f"max |diff| {err} > {tol}"


def test_mlp_guard_mirrors_the_kernel_shared_memory(cuda):
    import ctypes

    from gan_ffn_tpu_torch.ops import _build

    smem = _build.function("mlp_fwd", "gan_mlp_fwd_smem_bytes", [ctypes.c_int] * 2)
    for K, N in ((1, 1), (37, 33), (100, 100), (512, 512), (512, 100), (896, 512), (900, 513)):
        want = smem(K, N)
        assert (M._smem_bytes(K, N) if N <= M.MAX_OUT else 0) == want, (K, N)
        assert M.fused_mlp_supported(K, 64, N) == (0 < want <= M.SMEM_LIMIT), (K, N)


def _close(got, want, what):
    tol = 1e-4 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


@pytest.mark.parametrize("H,Dh", ATTN_HEADS)
@pytest.mark.parametrize("L", ATTN_LENGTHS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_backward_kernel_matches_plain(cuda, H, Dh, L, rate):
    rng = np.random.default_rng(L * 100 + Dh + 7)
    q, k, v, dout = (_randn(rng, (3, H, L, Dh), 1.0, cuda) for _ in range(4))
    for vl in _valid_lens(L):
        if rate > 0.0:  # the forward kernel's mask is the plain version's
            got = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=vl + 5)
            want = A.attention_plain(q, k, v, vl, rate, vl + 5)
            assert (got - want).abs().max().item() <= 1e-5, f"forward valid_len={vl}"
        before = A.fused_attention_backward.launches
        grads = A.fused_attention_backward(q, k, v, dout, vl, rate, vl + 5)
        again = A.fused_attention_backward(q, k, v, dout, vl, rate, vl + 5)
        torch.cuda.synchronize()
        assert A.fused_attention_backward.launches == before + 2
        want = A.attention_backward_plain(q, k, v, dout, vl, rate, vl + 5)
        for name, g, w, g2 in zip(("dq", "dk", "dv"), grads, want, again):
            _close(g, w, f"{name} valid_len={vl}")
            assert torch.equal(g, g2), f"{name}: two calls differ"


def test_attention_autograd_runs_both_kernels(cuda):
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, (2, 8, 50, 64), 1.0, cuda).requires_grad_() for _ in range(3))
    fwd, bwd = A.fused_attention.launches, A.fused_attention_backward.launches
    out = A.fused_attention(q, k, v, valid_len=40, dropout_rate=0.1, dropout_seed=3)
    # a permuted upstream gradient, as nn.transformer hands it over
    dout = _randn(rng, (50, 2, 8, 64), 1.0, cuda).permute(1, 2, 0, 3)
    out.backward(dout)
    assert (A.fused_attention.launches - fwd, A.fused_attention_backward.launches - bwd) == (1, 1)
    want = A.attention_backward_plain(q, k, v, dout, 40, 0.1, 3)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        _close(g, w, "autograd")


HEAD_DROP = dict(pre=("gelu", 0.2), mid=("gelu", "drop_first", 0.2),
                 post=("gelu", "drop_first", 0.2))
FFN_DROP = dict(mid=("relu", "act_first", 0.1))


@pytest.mark.parametrize(
    "K,H,N,cfg",
    [
        (100, 2048, 100, FFN),
        (100, 2048, 100, FFN_DROP),
        (512, 2048, 512, FFN_DROP),
        (100, 512, 100, HEAD),
        (100, 512, 100, HEAD_DROP),
        (512, 1024, 100, HEAD_DROP),
        (37, 100, 33, HEAD_DROP),  # ragged everywhere
        (64, 130, 260, FFN_DROP),  # H % 4 != 0
    ],
)
@pytest.mark.parametrize("rows", [1, 77, 3584])
def test_mlp_backward_kernel_matches_plain(cuda, K, H, N, cfg, rows):
    rng = np.random.default_rng(K + H + N + rows + 1)
    x = _randn(rng, (rows, K), 1.0, cuda)
    w1 = _randn(rng, (K, H), K ** -0.5, cuda)
    b1 = _randn(rng, (H,), 0.05, cuda)
    w2 = _randn(rng, (H, N), H ** -0.5, cuda)
    b2 = _randn(rng, (N,), 0.05, cuda)
    dout = _randn(rng, (rows, N), 1.0, cuda)
    seed = rows * 31 + K
    _close(M.fused_mlp(x, w1, b1, w2, b2, **cfg, dropout_seed=seed),
           M.mlp_plain(x, w1, b1, w2, b2, **cfg, dropout_seed=seed), "forward")
    before = M.fused_mlp_backward.launches
    grads = M.fused_mlp_backward(x, w1, b1, w2, b2, dout, **cfg, dropout_seed=seed)
    again = M.fused_mlp_backward(x, w1, b1, w2, b2, dout, **cfg, dropout_seed=seed)
    torch.cuda.synchronize()
    assert M.fused_mlp_backward.launches == before + 2
    want = M.mlp_backward_plain(x, w1, b1, w2, b2, dout, **cfg, dropout_seed=seed)
    for name, g, w, g2 in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want, again):
        _close(g, w, name)
        assert torch.equal(g, g2), f"{name}: two calls differ"


def test_mlp_autograd_runs_both_kernels(cuda):
    rng = np.random.default_rng(2)
    x = _randn(rng, (9, 7, 100), 1.0, cuda).requires_grad_()
    params = [_randn(rng, s, 0.1, cuda).requires_grad_() for s in ((100, 512), (512,), (512, 100), (100,))]
    fwd, bwd = M.fused_mlp.launches, M.fused_mlp_backward.launches
    out = M.fused_mlp(x, *params, **HEAD_DROP, dropout_seed=11)
    dout = _randn(rng, (9, 7, 100), 1.0, cuda)
    out.backward(dout)
    assert (M.fused_mlp.launches - fwd, M.fused_mlp_backward.launches - bwd) == (1, 1)
    want = M.mlp_backward_plain(x.detach().reshape(63, 100), *params, dout.reshape(63, 100),
                                **HEAD_DROP, dropout_seed=11)
    for g, w in zip((x.grad.reshape(63, 100), *(p.grad for p in params)), want):
        _close(g, w, "autograd")


def test_kernel_masks_keep_one_minus_rate(cuda):
    """The kernels' keep fraction is 1 - rate within 5 sigma: attention at
    (4, 8, 112, 64) with uniform weights, the FFN mid mask at M = 3584."""
    rate = 0.1
    B, H, L, Dh = 4, 8, 112, 64
    z = torch.zeros(B, H, L, Dh, device=cuda)
    v = torch.zeros(B, H, L, Dh, device=cuda)
    v[..., 0] = 1.0
    out = A.fused_attention(z, z, v, dropout_rate=rate, dropout_seed=123)
    # out[..., 0] = mean over keys of the mask: the kept fraction of each row
    kept = out[..., 0].mean().item() * (1 - rate)
    n = B * H * L * L
    assert abs(kept - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
    x = torch.zeros(3584, 100, device=cuda)
    w1 = torch.zeros(100, 2048, device=cuda)
    b1 = torch.ones(2048, device=cuda)
    w2 = torch.ones(2048, 1, device=cuda)
    out = M.fused_mlp(x, w1, b1, w2, torch.zeros(1, device=cuda),
                      mid=("relu", "act_first", rate), dropout_seed=9)
    kept = out.sum().item() * (1 - rate) / (3584 * 2048)
    assert abs(kept - (1 - rate)) <= 5 * (rate * (1 - rate) / (3584 * 2048)) ** 0.5
