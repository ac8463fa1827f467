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
compared element by element at any rate.  The kernels read ``valid_len``
and their seed from device memory: a host int is written there first, and
``test_kernels_read_valid_len_and_seed_from_device_memory`` passes both as
tensors, the seed derived from a step's base (``ops.dropout.SeedRef``).  Tolerances: attention forward max
|diff| <= 1e-5 (one softmax over <= 128 keys in f32); attention backward
and both MLP kernels max |diff| <= 1e-4 * max(1, max |ref|) (sums of f32
products in another order, and erff against torch's erf).  The backward
kernels sum in a fixed order, so two calls give identical bits.

The bf16 forward kernels (``attention_fwd_bf16``, ``mlp_fwd_bf16``) are
held to the plain versions at bf16, which round at the same points, within
max |diff| <= 2^-8 * max(1, max |ref|) (bf16's unit roundoff at the
largest output) with at least 99% of the elements identical (+0 and -0 as
one value: a dropped weight's zero products carry either sign); both take
each sum exactly and round it to f32 once, so a rounded value differs only
where an intermediate lies within about an f32 ulp of a rounding boundary.
The bf16 backward kernels (``attention_bwd_bf16``, ``mlp_bwd_bf16``) are
held to their plain versions at bf16 under the same limits.  Two calls give
identical bits.
"""

import numpy as np
import pytest
import torch
from tf32_emulation import away_from_relu_kink

from gan_ffn_tpu_torch.ops import attention as A
from gan_ffn_tpu_torch.ops import dropout as D
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


@pytest.mark.parametrize("H,Dh", [(10, 10), (8, 64)])
@pytest.mark.parametrize("L", [32, 64, 96, 112])
def test_attention_kernels_at_the_dialoguernn_batch(cuda, H, Dh, L):
    """Both kernels at the GAN_FFN_DialogueRNN trainer's shapes, B = 30 and
    the buckets it fills, at the path's rate 0.1 with a valid_len short of
    L, and at rate 0 (eval)."""
    rng = np.random.default_rng(L + Dh + 30)
    q, k, v, dout = (_randn(rng, (30, H, L, Dh), 1.0, cuda) for _ in range(4))
    for rate, vl in ((0.1, L - 5), (0.0, L)):
        got = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=L)
        grads = A.fused_attention_backward(q, k, v, dout, vl, rate, L)
        torch.cuda.synchronize()
        err = (got - A.attention_plain(q, k, v, vl, rate, L)).abs().max().item()
        assert err <= 1e-5, f"rate={rate}: forward max |diff| {err}"
        want = A.attention_backward_plain(q, k, v, dout, vl, rate, L)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            _close(g, w, f"{name} rate={rate}")


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
        (100, 2048, 1024, FFN),  # N past 512: 16 pieces of the output, a 117 MB workspace
        (4096, 256, 64, HEAD),  # K past 896: 128 k-slices to one z1 tile
    ],
)
# 3584 and 3360 rows: L = 112 at B = 32 (GAN_FFN) and at B = 30 (GAN_FFN_DialogueRNN)
@pytest.mark.parametrize("rows", [1, 77, 3584, 3360])
def test_mlp_kernel_matches_plain(cuda, K, H, N, cfg, rows):
    rng = np.random.default_rng(K + H + N + rows)
    x = _randn(rng, (rows, K), 1.0, cuda)
    w1 = _randn(rng, (K, H), K ** -0.5, cuda)
    b1 = _randn(rng, (H,), 0.05, cuda)
    w2 = _randn(rng, (H, N), H ** -0.5, cuda)
    b2 = _randn(rng, (N,), 0.05, cuda)
    before = M.fused_mlp.launches
    got = M.fused_mlp(x, w1, b1, w2, b2, **cfg)
    again = M.fused_mlp(x, w1, b1, w2, b2, **cfg)
    torch.cuda.synchronize()
    assert M.fused_mlp.launches == before + 2
    want = M.mlp_plain(x, w1, b1, w2, b2, **cfg)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, f"max |diff| {err} > {tol}"
    assert torch.equal(got, again), "two calls differ"


def test_mlp_fwd_workspace_mirrors_the_kernel(cuda):
    import ctypes

    from gan_ffn_tpu_torch.ops import _build

    query = _build.function("mlp_fwd", "gan_mlp_fwd_workspace_floats", [ctypes.c_int] * 4,
                            ctypes.c_longlong)
    for rows in (1, 77, 1000, 3360, 3584, 3585, 20000):
        for K, H, N in ((100, 2048, 100), (512, 2048, 512), (100, 512, 100), (512, 1024, 100),
                        (37, 100, 33), (64, 130, 260), (100, 300, 200), (100, 2048, 1024),
                        (4096, 256, 64)):
            assert query(rows, K, H, N) == M.fwd_workspace_floats(rows, K, H, N), (rows, K, H, N)


@pytest.mark.parametrize("K,H,N,cfg", [(37, 100, 33, HEAD), (64, 128, 100, FFN)])
def test_mlp_forward_unsplit_matches_plain(cuda, K, H, N, cfg):
    """d_ff in one chunk and 313 row tiles: the block applies b2 and post
    itself (no workspace, no second kernel)."""
    rows = 20000
    assert M.fwd_launch(rows, K, H, N)["chunks"] == 1
    rng = np.random.default_rng(K + H + N)
    x = _randn(rng, (rows, K), 1.0, cuda)
    w1 = _randn(rng, (K, H), K ** -0.5, cuda)
    b1 = _randn(rng, (H,), 0.05, cuda)
    w2 = _randn(rng, (H, N), H ** -0.5, cuda)
    b2 = _randn(rng, (N,), 0.05, cuda)
    for rate in (0.0, 0.2):
        c = {k: (*v[:-1], rate) for k, v in cfg.items()}
        got = M.fused_mlp(x, w1, b1, w2, b2, **c, dropout_seed=5)
        _close(got, M.mlp_plain(x, w1, b1, w2, b2, **c, dropout_seed=5), f"rate={rate}")


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
        (36, 204, 60, HEAD_DROP),  # K, H, N % 8 != 0: 16-byte copies, partial mma tiles
        (100, 2048, 1024, FFN_DROP),  # N past 512
        (4096, 256, 64, HEAD_DROP),  # K past 896
    ],
)
# 1000 and 3585 rows make the last chunk of the split reductions over M ragged;
# 3360 is B = 30 at L = 112 (GAN_FFN_DialogueRNN), with other chunks than 3584
@pytest.mark.parametrize("rows", [1, 77, 1000, 3584, 3585, 3360])
def test_mlp_backward_kernel_matches_plain(cuda, K, H, N, cfg, rows):
    rng = np.random.default_rng(K + H + N + rows + 1)
    x = _randn(rng, (rows, K), 1.0, cuda)
    w1 = _randn(rng, (K, H), K ** -0.5, cuda)
    b1 = _randn(rng, (H,), 0.05, cuda)
    w2 = _randn(rng, (H, N), H ** -0.5, cuda)
    b2 = _randn(rng, (N,), 0.05, cuda)
    dout = _randn(rng, (rows, N), 1.0, cuda)
    if cfg["mid"][0] == "relu":
        x = away_from_relu_kink(x, w1, b1, lambda n: _randn(rng, (n, K), 1.0, cuda))
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


def test_mlp_bwd_workspace_mirrors_the_kernel(cuda):
    import ctypes

    from gan_ffn_tpu_torch.ops import _build

    query = _build.function("mlp_bwd", "gan_mlp_bwd_workspace_floats", [ctypes.c_int] * 4,
                            ctypes.c_longlong)
    for rows in (1, 77, 1000, 3360, 3584, 3585):
        for K, H, N in ((100, 2048, 100), (512, 2048, 512), (100, 512, 100), (512, 1024, 100),
                        (37, 100, 33), (36, 204, 60), (100, 2048, 1024), (4096, 256, 64)):
            assert query(rows, K, H, N) == M.bwd_workspace_floats(rows, K, H, N), (rows, K, H, N)


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


def near_kink_inputs(rng, rows, K, H, pre, device):
    """x, w1, b1 of a K -> H relu FFN whose z1 mostly lie within ~1e-6 of 0:
    every row is x0 plus noise of 1e-6, and b1 = -(pre(x0) w1) in f64,
    rounded to f32.  The sign of such a z1 depends on the order of its sum."""
    x0 = rng.standard_normal(K)
    x = (x0 + 1e-6 * rng.standard_normal((rows, K))).astype(np.float32)
    w1 = (rng.standard_normal((K, H)) * K ** -0.5).astype(np.float32)
    t0 = torch.from_numpy(x0.astype(np.float32)).double()
    if pre is not None:
        t0 = torch.nn.functional.gelu(t0)
    b1 = -(t0 @ torch.from_numpy(w1).double()).float()
    return (torch.from_numpy(x).to(device), torch.from_numpy(w1).to(device), b1.to(device))


@pytest.mark.parametrize("K,pre", [(100, None), (512, None), (100, "gelu")])
@pytest.mark.parametrize("rows", [1, 3584])
def test_mlp_forward_and_backward_take_the_same_relu_branches(cuda, K, pre, rows):
    """Both kernels compute z1 through the same tile code, so relu' takes in
    the backward the branch relu took in the forward, even where z1 is
    within rounding of 0.  With W2 = I, b2 = 0 and no post, out > 0 exactly
    where the forward's z1 > 0.  dout holds whole numbers from 1 to 1024:
    the backward's db1 = sum_r dout[r, j] relu'(z1[r, j]) is then exact in
    f32 (every term and partial sum is a whole number below 2**24), and a
    row taking the other branch moves its column by its dout, so two rows
    that took opposite branches cancel only where their dout are equal."""
    H = 512
    rng = np.random.default_rng(K + rows)
    x, w1, b1 = near_kink_inputs(rng, rows, K, H, pre, cuda)
    cfg = dict(mid=("relu", "act_first", 0.0))
    if pre is not None:
        cfg["pre"] = (pre, 0.0)
    eye, zero = torch.eye(H, device=cuda), torch.zeros(H, device=cuda)
    dout = torch.from_numpy(rng.integers(1, 1025, (rows, H)).astype(np.float32)).to(cuda)
    out = M.fused_mlp(x, w1, b1, eye, zero, **cfg)
    again = M.fused_mlp(x, w1, b1, eye, zero, **cfg)
    db1 = M.fused_mlp_backward(x, w1, b1, eye, zero, dout, **cfg)[2]
    torch.cuda.synchronize()
    t1 = x.double() if pre is None else torch.nn.functional.gelu(x.double())
    near = ((t1 @ w1.double() + b1.double()).abs() < 1e-6).sum().item()
    assert near >= rows * H // 10, f"only {near} of {rows * H} z1 within 1e-6 of 0"
    assert torch.equal(out, again), "two forward calls differ"
    want = (dout.double() * (out > 0)).sum(0)
    assert torch.equal(db1.double(), want), (
        f"{(db1.double() != want).sum().item()} columns take other branches")


@pytest.mark.parametrize("index", [-1, 0, 7])
def test_kernels_read_valid_len_and_seed_from_device_memory(cuda, index):
    """valid_len as a 0-d int32 tensor and the seed as a ``SeedRef`` (index
    k >= 0: the seed that csrc/philox.cuh derives from (base, k), held here
    to ``ops.dropout.derive_seed``; k < 0: the base itself) against the
    plain versions at the host ints, under the limits above."""
    rng = np.random.default_rng(11)
    base_value = 0x5DEECE66D + index
    ref = D.SeedRef(torch.tensor(base_value, dtype=torch.int64, device=cuda), index)
    seed = D.derive_seed(base_value, index)
    q, k, v, do = (_randn(rng, (3, 2, 37, 16), 1.0, cuda) for _ in range(4))
    for vl in (37, 20, 1, 0):
        tvl = torch.tensor(vl, dtype=torch.int32, device=cuda)
        got = A.fused_attention(q, k, v, valid_len=tvl, dropout_rate=0.1, dropout_seed=ref)
        want = A.attention_plain(q, k, v, vl, 0.1, seed)
        assert (got - want).abs().max().item() <= 1e-5, f"valid_len={vl}"
        grads = A.fused_attention_backward(q, k, v, do, tvl, 0.1, ref)
        for g, w in zip(grads, A.attention_backward_plain(q, k, v, do, vl, 0.1, seed)):
            _close(g, w, f"attention backward valid_len={vl}")
    K, H, N, rows = 37, 100, 33, 77
    x, w1, b1 = _randn(rng, (rows, K), 1.0, cuda), _randn(rng, (K, H), K ** -0.5, cuda), \
        _randn(rng, (H,), 0.05, cuda)
    w2, b2 = _randn(rng, (H, N), H ** -0.5, cuda), _randn(rng, (N,), 0.05, cuda)
    dout = _randn(rng, (rows, N), 1.0, cuda)
    cfg = {k: (*v[:-1], 0.2) for k, v in HEAD.items()}
    _close(M.fused_mlp(x, w1, b1, w2, b2, **cfg, dropout_seed=ref),
           M.mlp_plain(x, w1, b1, w2, b2, **cfg, dropout_seed=seed), "mlp forward")
    for g, w in zip(M.fused_mlp_backward(x, w1, b1, w2, b2, dout, **cfg, dropout_seed=ref),
                    M.mlp_backward_plain(x, w1, b1, w2, b2, dout, **cfg, dropout_seed=seed)):
        _close(g, w, "mlp backward")


BF16_TOL = 2.0 ** -8  # relative to max(1, max |ref|)
BF16_SAME = 0.99  # least share of outputs identical


def _bf16(rng, shape, scale, device):
    return _randn(rng, shape, scale, device).to(torch.bfloat16)


def _bf16_close(got, want, what):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, what
    tol = BF16_TOL * max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    same = (got == want).double().mean().item()  # +0 and -0 as one value
    assert err <= tol and same >= BF16_SAME, (
        f"{what}: max |diff| {err} (limit {tol}), {same:.5f} of the elements identical "
        f"(limit {BF16_SAME})")


@pytest.mark.parametrize("H,Dh", [(10, 10), (8, 64), (3, 7), (2, 16), (2, 33)])
@pytest.mark.parametrize("L", [1, 17, 37, 112, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_bf16_kernel_matches_plain(cuda, H, Dh, L, rate):
    rng = np.random.default_rng(L * 100 + Dh + 7)
    q, k, v = (_bf16(rng, (3, H, L, Dh), 1.0, cuda) for _ in range(3))
    for vl in _valid_lens(L):
        before = (A.attention_fwd_bf16.launches, A.fused_attention.launches)
        got = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=vl + 3)
        again = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=vl + 3)
        torch.cuda.synchronize()
        assert (A.attention_fwd_bf16.launches, A.fused_attention.launches) == (
            before[0] + 2, before[1])
        _bf16_close(got, A.attention_plain(q, k, v, vl, rate, vl + 3), f"valid_len={vl}")
        assert torch.equal(got, again), f"valid_len={vl}: two calls differ"


@pytest.mark.parametrize(
    "K,H,N,cfg",
    [
        (100, 2048, 100, FFN),
        (512, 2048, 512, FFN),
        (100, 512, 100, HEAD),
        (512, 1024, 100, HEAD),
        (37, 100, 33, HEAD),  # ragged everywhere: 2-byte copies and single stores
        (100, 300, 200, HEAD),  # a partial d_ff chunk, 4 output pieces
    ],
)
@pytest.mark.parametrize("rows", [1, 77, 3584])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_mlp_bf16_kernel_matches_plain(cuda, K, H, N, cfg, rows, rate):
    rng = np.random.default_rng(K + H + N + rows + 5)
    x = _bf16(rng, (rows, K), 1.0, cuda)
    w1, b1 = _bf16(rng, (K, H), K ** -0.5, cuda), _bf16(rng, (H,), 0.05, cuda)
    w2, b2 = _bf16(rng, (H, N), H ** -0.5, cuda), _bf16(rng, (N,), 0.05, cuda)
    cfg = {k: (*c[:-1], rate) for k, c in cfg.items()}
    before = (M.mlp_fwd_bf16.launches, M.fused_mlp.launches)
    got = M.fused_mlp(x, w1, b1, w2, b2, **cfg, dropout_seed=11)
    again = M.fused_mlp(x, w1, b1, w2, b2, **cfg, dropout_seed=11)
    torch.cuda.synchronize()
    assert (M.mlp_fwd_bf16.launches, M.fused_mlp.launches) == (before[0] + 2, before[1])
    _bf16_close(got, M.mlp_plain(x, w1, b1, w2, b2, **cfg, dropout_seed=11), "mlp forward")
    assert torch.equal(got, again), "two calls differ"


def test_mlp_bf16_workspace_mirrors_the_split(cuda):
    from gan_ffn_tpu_torch.ops import _build
    import ctypes

    fn = _build.function("mlp_fwd_bf16", "gan_mlp_fwd_bf16_workspace_floats",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    for M_, K, H, N in ((3584, 100, 2048, 100), (3584, 512, 1024, 100), (77, 37, 100, 33),
                        (1, 512, 2048, 512)):
        assert fn(M_, K, H, N) == M.fwd_workspace_floats(M_, K, H, N)


def test_bf16_kernels_read_valid_len_and_seed_from_device_memory(cuda):
    rng = np.random.default_rng(12)
    ref = D.SeedRef(torch.tensor(0x5DEECE66D, dtype=torch.int64, device=cuda), 3)
    seed = D.derive_seed(0x5DEECE66D, 3)
    q, k, v = (_bf16(rng, (3, 2, 37, 16), 1.0, cuda) for _ in range(3))
    for vl in (37, 20, 1, 0):
        tvl = torch.tensor(vl, dtype=torch.int32, device=cuda)
        _bf16_close(A.fused_attention(q, k, v, valid_len=tvl, dropout_rate=0.1, dropout_seed=ref),
                    A.attention_plain(q, k, v, vl, 0.1, seed), f"attention valid_len={vl}")
    x, w1, b1 = _bf16(rng, (77, 100), 1.0, cuda), _bf16(rng, (100, 512), 0.1, cuda), \
        _bf16(rng, (512,), 0.05, cuda)
    w2, b2 = _bf16(rng, (512, 100), 512 ** -0.5, cuda), _bf16(rng, (100,), 0.05, cuda)
    cfg = {k: (*c[:-1], 0.2) for k, c in HEAD.items()}
    _bf16_close(M.fused_mlp(x, w1, b1, w2, b2, **cfg, dropout_seed=ref),
                M.mlp_plain(x, w1, b1, w2, b2, **cfg, dropout_seed=seed), "mlp")


def test_bf16_kernels_refuse_a_gradient_and_mixed_dtypes(cuda):
    """A bf16 call with a gradient runs the bf16 kernels both ways; operands
    of two dtypes are refused."""
    q = torch.zeros(1, 2, 8, 16, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    before = (A.attention_fwd_bf16.launches, A.attention_bwd_bf16.launches)
    A.fused_attention(q, q, q).float().sum().backward()
    assert (A.attention_fwd_bf16.launches, A.attention_bwd_bf16.launches) == (
        before[0] + 1, before[1] + 1)
    assert q.grad.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="one dtype"):
        A.fused_attention(q.detach(), q.detach().float(), q.detach())
    x = torch.zeros(4, 8, device=cuda, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(8, 16, device=cuda), torch.zeros(16, 8, device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        M.fused_mlp(x, w1, torch.zeros(16, device=cuda), w2, torch.zeros(8, device=cuda))


# The bf16 backward kernels against their plain versions (the same limits).


@pytest.mark.parametrize("H,Dh", [(10, 10), (8, 64), (3, 7), (2, 16), (2, 33)])
@pytest.mark.parametrize("L", [1, 17, 37, 112, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_bf16_backward_kernel_matches_plain(cuda, H, Dh, L, rate):
    rng = np.random.default_rng(L * 100 + Dh + 9)
    q, k, v, dout = (_bf16(rng, (3, H, L, Dh), 1.0, cuda) for _ in range(4))
    for vl in _valid_lens(L):
        before = A.attention_bwd_bf16.launches
        grads = A.fused_attention_backward(q, k, v, dout, vl, rate, vl + 5)
        again = A.fused_attention_backward(q, k, v, dout, vl, rate, vl + 5)
        torch.cuda.synchronize()
        assert A.attention_bwd_bf16.launches == before + 2
        want = A.attention_backward_plain(q, k, v, dout, vl, rate, vl + 5)
        for name, g, w, g2 in zip(("dq", "dk", "dv"), grads, want, again):
            _bf16_close(g, w, f"{name} valid_len={vl}")
            assert torch.equal(g, g2), f"{name}: two calls differ"


def test_attention_bf16_autograd_runs_both_kernels(cuda):
    rng = np.random.default_rng(3)
    q, k, v = (_bf16(rng, (2, 8, 50, 64), 1.0, cuda).requires_grad_() for _ in range(3))
    fwd, bwd = A.attention_fwd_bf16.launches, A.attention_bwd_bf16.launches
    f32 = (A.fused_attention.launches, A.fused_attention_backward.launches)
    out = A.fused_attention(q, k, v, valid_len=40, dropout_rate=0.1, dropout_seed=3)
    dout = _bf16(rng, (50, 2, 8, 64), 1.0, cuda).permute(1, 2, 0, 3)
    out.backward(dout)
    assert (A.attention_fwd_bf16.launches - fwd, A.attention_bwd_bf16.launches - bwd) == (1, 1)
    assert (A.fused_attention.launches, A.fused_attention_backward.launches) == f32
    want = A.attention_backward_plain(q.detach(), k.detach(), v.detach(), dout, 40, 0.1, 3)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        _bf16_close(g, w, "autograd")


@pytest.mark.parametrize(
    "K,H,N,cfg",
    [
        (100, 2048, 100, FFN_DROP),
        (512, 2048, 512, FFN_DROP),
        (100, 512, 100, HEAD),
        (100, 512, 100, HEAD_DROP),
        (512, 1024, 100, HEAD_DROP),
        (37, 100, 33, HEAD_DROP),  # ragged everywhere: 2-byte copies, single stores
        (36, 204, 60, FFN_DROP),  # K, H, N % 8 != 0
    ],
)
# 1000 and 3585 rows make the last chunk of the split reductions over M ragged;
# 3360 is B = 30 at L = 112 (GAN_FFN_DialogueRNN)
@pytest.mark.parametrize("rows", [1, 77, 1000, 3360, 3584, 3585])
def test_mlp_bf16_backward_kernel_matches_plain(cuda, K, H, N, cfg, rows):
    rng = np.random.default_rng(K + H + N + rows + 3)
    x = _bf16(rng, (rows, K), 1.0, cuda)
    w1, b1 = _bf16(rng, (K, H), K ** -0.5, cuda), _bf16(rng, (H,), 0.05, cuda)
    w2, b2 = _bf16(rng, (H, N), H ** -0.5, cuda), _bf16(rng, (N,), 0.05, cuda)
    dout = _bf16(rng, (rows, N), 1.0, cuda)
    seed = rows * 31 + K
    before = (M.mlp_bwd_bf16.launches, M.fused_mlp_backward.launches)
    grads = M.fused_mlp_backward(x, w1, b1, w2, b2, dout, **cfg, dropout_seed=seed)
    again = M.fused_mlp_backward(x, w1, b1, w2, b2, dout, **cfg, dropout_seed=seed)
    torch.cuda.synchronize()
    assert (M.mlp_bwd_bf16.launches, M.fused_mlp_backward.launches) == (before[0] + 2, before[1])
    want = M.mlp_backward_plain(x, w1, b1, w2, b2, dout, **cfg, dropout_seed=seed)
    for name, g, w, g2 in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want, again):
        _bf16_close(g, w, name)
        assert torch.equal(g, g2), f"{name}: two calls differ"


def test_mlp_bf16_bwd_workspace_mirrors_the_kernel(cuda):
    import ctypes

    from gan_ffn_tpu_torch.ops import _build

    query = _build.function("mlp_bwd_bf16", "gan_mlp_bwd_bf16_workspace_doubles",
                            [ctypes.c_int] * 4, ctypes.c_longlong)
    for rows in (1, 77, 1000, 3360, 3584, 3585):
        for K, H, N in ((100, 2048, 100), (512, 2048, 512), (100, 512, 100), (512, 1024, 100),
                        (37, 100, 33), (36, 204, 60)):
            assert query(rows, K, H, N) == M.bwd_bf16_workspace_doubles(rows, K, H, N), (
                rows, K, H, N)


def test_mlp_bf16_autograd_runs_both_kernels(cuda):
    rng = np.random.default_rng(4)
    x = _bf16(rng, (9, 7, 100), 1.0, cuda).requires_grad_()
    params = [_bf16(rng, s, 0.1, cuda).requires_grad_()
              for s in ((100, 512), (512,), (512, 100), (100,))]
    fwd, bwd = M.mlp_fwd_bf16.launches, M.mlp_bwd_bf16.launches
    f32 = (M.fused_mlp.launches, M.fused_mlp_backward.launches)
    out = M.fused_mlp(x, *params, **HEAD_DROP, dropout_seed=11)
    dout = _bf16(rng, (9, 7, 100), 1.0, cuda)
    out.backward(dout)
    assert (M.mlp_fwd_bf16.launches - fwd, M.mlp_bwd_bf16.launches - bwd) == (1, 1)
    assert (M.fused_mlp.launches, M.fused_mlp_backward.launches) == f32
    want = M.mlp_backward_plain(x.detach().reshape(63, 100), *(p.detach() for p in params),
                                dout.reshape(63, 100), **HEAD_DROP, dropout_seed=11)
    for g, w in zip((x.grad.reshape(63, 100), *(p.grad for p in params)), want):
        _bf16_close(g, w, "autograd")


@pytest.mark.parametrize("K,pre", [(100, None), (512, None), (100, "gelu")])
def test_mlp_bf16_forward_and_backward_take_the_same_relu_branches(cuda, K, pre):
    """The bf16 kernels compute z1 through the same tile code
    (csrc/mlp_bf16_tile.cuh).  With W2 = I, b2 = 0 and no post, out > 0
    exactly where the forward's z1 > 0; b1 = -bf16(t1 W1) of one row puts
    z1 near 0.  Eight rows a call with dout = 2^r (r = 0 .. 7): db1 =
    sum_r 2^r relu'(z1[r, j]) is a whole number below 256, exact at bf16,
    whose bits name the rows where relu' is 1."""
    H = 512
    rng = np.random.default_rng(K + 17)
    cfg = dict(mid=("relu", "act_first", 0.0))
    if pre is not None:
        cfg["pre"] = (pre, 0.0)
    eye, zero = (torch.eye(H, device=cuda, dtype=torch.bfloat16),
                 torch.zeros(H, device=cuda, dtype=torch.bfloat16))
    w1 = _bf16(rng, (K, H), K ** -0.5, cuda)
    dout = (2.0 ** torch.arange(8, device=cuda))[:, None].expand(8, H).to(torch.bfloat16)
    flips = 0
    for group in range(16):
        x0 = _bf16(rng, (1, K), 1.0, cuda)
        x = (x0 + _bf16(rng, (8, K), 2.0 ** -7, cuda)).to(torch.bfloat16)
        t0 = x0.double() if pre is None else torch.nn.functional.gelu(x0.double())
        b1 = (-(t0 @ w1.double())[0]).to(torch.bfloat16)
        out = M.fused_mlp(x, w1, b1, eye, zero, **cfg)
        db1 = M.fused_mlp_backward(x, w1, b1, eye, zero, dout, **cfg)[2]
        want = (dout.double() * (out > 0)).sum(0)
        flips += (db1.double() != want).sum().item()
    assert flips == 0, f"{flips} columns take other branches"
