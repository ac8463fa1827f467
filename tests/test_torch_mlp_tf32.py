"""Why the MLP backward kernel's arithmetic meets its limit: the algorithm of
``csrc/mlp_bwd.cu`` emulated on the CPU.

The kernel runs every product on the tensor cores as TF32 ``mma.sync`` in
the 3xTF32 split of ``split_fast`` (``tests/tf32_emulation.py``: hi rounded
by bit masking as the kernel does, lo truncated as the tensor core reads
it), and splits the long reductions of dx (over H) and of dW1, db1,
dW2, db2 (over M) into the chunks of ``ops.mlp.split_reduction``, which the
kernel sums in ascending order; db comes from a ones column appended to A.
Here the same algorithm, with the same Philox masks (``keep_scale``), runs
at M = 3584 for the four MLP geometries of the training path at the path's
dropout rates (FFN mid 0.1; head pre, mid and post 0.2), and each gradient
is held to ``mlp_backward_plain`` within 1e-4 * max(1, max |ref|), the card
tests' limit.  Products of two TF32 values are exact in f32 and the sums
are f32, as on the tensor cores; the order of the sums inside a chunk
differs from the card's.

One TF32 pass instead of three misses the limit: emulated the same way, it
is off by 5.3e-4 (100->512->100) to 8.1e-2 (100->2048->100, where its
error in z1 also flips branches of relu') at the worst gradient, where the
3xTF32 split stays within 1.1e-6.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from tf32_emulation import away_from_relu_kink, mm_3x_fast

from gan_ffn_tpu_torch.ops import mlp as M
from gan_ffn_tpu_torch.ops.dropout import STREAM_MID, STREAM_POST, STREAM_PRE, keep_scale

GRAD_TOL = 1e-4  # relative to max(1, max |ref|)
ROWS = 3584


def _act(name, z):
    return torch.relu(z) if name == "relu" else F.gelu(z)


def _act_grad(name, z):
    if name == "relu":
        return (z > 0).to(z.dtype)
    return 0.5 * (1 + torch.erf(z * 0.7071067811865476)) + z * torch.exp(-0.5 * z * z) * 0.3989422804014327


def split_mm(mm, a, b, tiles):
    """a @ b over the chunks the kernel gives a launch of ``tiles`` output
    tiles, the partial products summed in ascending chunk order."""
    S, chunk = M.split_reduction(tiles, a.shape[1])
    total = mm(a[:, :chunk], b[:chunk])
    for s in range(1, S):
        total = total + mm(a[:, s * chunk:(s + 1) * chunk], b[s * chunk:(s + 1) * chunk])
    return total


def kernel_backward(mm, x, w1, b1, w2, b2, dout, pre=None, mid=("relu", "act_first", 0.0),
                    post=None, dropout_seed=0):
    """(dx, dw1, db1, dw2, db2) by mlp_bwd.cu's algorithm with the product ``mm``."""
    (a_pre, a_mid, order, a_post), (r_pre, r_mid, r_post) = M._parse_chain(pre, mid, post)
    rows, K = x.shape
    H, N = w2.shape

    def mask(stream, cols, rate):
        return keep_scale(dropout_seed, stream, (rows, cols), rate, x.device)

    t1 = x
    if a_pre is not None:
        t1 = _act(a_pre, x)
        if r_pre > 0:
            t1 = t1 * mask(STREAM_PRE, K, r_pre)
    z1 = mm(t1, w1) + b1
    if r_mid > 0:
        m = mask(STREAM_MID, H, r_mid)
        if order == "act_first":
            a1, d1 = _act(a_mid, z1) * m, m * _act_grad(a_mid, z1)
        else:
            a1, d1 = _act(a_mid, z1 * m), _act_grad(a_mid, z1 * m) * m
    else:
        a1, d1 = _act(a_mid, z1), _act_grad(a_mid, z1)
    g = dout
    if a_post is not None:
        z2 = mm(a1, w2) + b2
        ks = mask(STREAM_POST, N, r_post) if r_post > 0 else 1.0
        g = dout * _act_grad(a_post, z2 * ks) * ks
    dz1 = mm(g, w2.T) * d1
    tiles = {l["name"]: l["tiles"] for l in M.bwd_launches(rows, K, H, N)}
    dx = split_mm(mm, dz1, w1.T, tiles["dx"])
    if a_pre is not None:
        if r_pre > 0:
            dx = dx * mask(STREAM_PRE, K, r_pre)
        dx = dx * _act_grad(a_pre, x)
    ones = torch.ones(rows, 1)
    dw1 = split_mm(mm, torch.cat([t1, ones], 1).T, dz1, tiles["dw1_db1"])
    dw2 = split_mm(mm, torch.cat([a1, ones], 1).T, g, tiles["dw2_db2"])
    return dx, dw1[:K], dw1[K], dw2[:H], dw2[H]


def _site(site, rate):
    if site == "ffn":
        return dict(mid=("relu", "act_first", rate))
    return dict(pre=("gelu", rate), mid=("gelu", "drop_first", rate),
                post=("gelu", "drop_first", rate))


def _inputs(rows, K, H, N, site):
    """x, w1, b1, w2, b2, dout from a seed; for the relu FFN, x away from
    relu's kink (``away_from_relu_kink``)."""
    rng = np.random.default_rng(rows + K + H + N)

    def randn(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x, w1, b1 = randn((rows, K), 1.0), randn((K, H), K ** -0.5), randn((H,), 0.05)
    if site == "ffn":
        x = away_from_relu_kink(x, w1, b1, lambda n: randn((n, K), 1.0))
    return x, w1, b1, randn((H, N), H ** -0.5), randn((N,), 0.05), randn((rows, N), 1.0)


def _error(mm, rows, K, H, N, site, rate):
    """max over the five gradients of max |diff| / max(1, max |ref|)."""
    args = _inputs(rows, K, H, N, site)
    cfg = _site(site, rate)
    got = kernel_backward(mm, *args, **cfg, dropout_seed=rows * 31 + K)
    want = M.mlp_backward_plain(*args, **cfg, dropout_seed=rows * 31 + K)
    return max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
               for g, w in zip(got, want))


PATH = [(100, 2048, 100, "ffn", 0.1), (512, 2048, 512, "ffn", 0.1),
        (100, 512, 100, "head", 0.2), (512, 1024, 100, "head", 0.2)]


@pytest.mark.parametrize("K,H,N,site,rate", PATH)
def test_3xtf32_split_reductions_meet_the_limit(K, H, N, site, rate):
    err = _error(mm_3x_fast, ROWS, K, H, N, site, rate)
    assert err <= GRAD_TOL, f"max |diff| / max(1, max |ref|) {err}"


@pytest.mark.parametrize("rows", [77, 3585])
def test_a_ragged_last_chunk_meets_the_limit(rows):
    K, H, N = 100, 512, 100
    launches = M.bwd_launches(rows, K, H, N)
    assert any(l["chunks"] > 1 and l["depth"] % l["chunk"] for l in launches), launches
    err = _error(mm_3x_fast, rows, K, H, N, "head", 0.2)
    assert err <= GRAD_TOL, f"max |diff| / max(1, max |ref|) {err}"


@pytest.mark.parametrize("K,H,N,site,rate", PATH)
def test_every_long_reduction_fills_the_card(K, H, N, site, rate):
    """At M = 3584 dx, dW1 and dW2 each run >= 256 blocks (tiles x chunks)
    and at most one wave, in chunks of whole k-slices that cover the
    reduction; the workspace stays under 10 MB."""
    for l in M.bwd_launches(ROWS, K, H, N):
        S, chunk, depth, tiles = l["chunks"], l["chunk"], l["depth"], l["tiles"]
        assert 256 <= l["blocks"] == tiles * S, l
        assert S == 1 or l["blocks"] <= M.BWD_WAVE_BLOCKS, l
        assert chunk % 32 == 0 and (S - 1) * chunk < depth <= S * chunk, l
    assert M.bwd_workspace_floats(ROWS, K, H, N) * 4 <= 10**7


def test_split_reduction_edges():
    assert M.split_reduction(265, 3584) == (1, 3584)  # over half a wave: no split
    assert M.split_reduction(264, 3584) == (2, 1792)  # half a wave: two chunks
    assert M.split_reduction(1, 20) == (1, 32)  # one slice: nothing to split
    assert M.split_reduction(1, 3584) == (112, 32)  # single k-slices
    assert M.split_reduction(16, 77) == (3, 32)  # 77 = 32 + 32 + 13
    assert M.split_reduction(18, 3584) == (28, 128)  # 29 asked; 4-slice chunks make 28
