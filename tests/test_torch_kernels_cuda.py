"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda_hardware``: every test skips where ``torch.cuda.is_available()``
is False (the CPU gate), and runs the hand-written kernels wherever a CUDA
card is present:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Shapes cover the serving path's geometries at small batch plus ragged
edges (L and M not multiples of the kernels' tiles).  Tolerances: attention
max |diff| <= 1e-5 (one softmax over <= 128 keys in f32); MLP max |diff| <=
1e-4 * max(1, max |ref|) (sums over d_ff <= 2048 products in another order,
and erff against torch's erf).
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


@pytest.mark.parametrize("H,Dh", [(10, 10), (8, 64), (3, 7)])
@pytest.mark.parametrize("L", [1, 37, 112, 128])
def test_attention_kernel_matches_plain(cuda, H, Dh, L):
    rng = np.random.default_rng(L * 100 + Dh)
    q, k, v = (_randn(rng, (3, H, L, Dh), 1.0, cuda) for _ in range(3))
    for vl in sorted({L, max(L - 3, 0), 1, 0}):
        before = A.fused_attention.launches
        got = A.fused_attention(q, k, v, valid_len=vl)
        torch.cuda.synchronize()
        assert A.fused_attention.launches == before + 1
        want = A.attention_plain(q, k, v, vl)
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
