"""Why the MLP kernels' arithmetic meets its limit: the algorithms of
``csrc/mlp_fwd.cu`` and ``csrc/mlp_bwd.cu`` emulated on the CPU.

The kernels run every product on the tensor cores as TF32 ``mma.sync`` in
the 3xTF32 split of ``split_fast`` (``tests/tf32_emulation.py``: hi rounded
by bit masking as the kernel does, lo truncated as the tensor core reads
it).  The backward splits the long reductions of dx (over H) and of dW1,
db1, dW2, db2 (over M) into the chunks of ``ops.mlp.split_reduction``, which
the kernel sums in ascending order; db comes from a ones column appended to
A.  The forward computes z1 as the backward does, keeps a1 on chip, and
multiplies it by W2 in the d_ff chunks of ``ops.mlp.fwd_split``, whose
partial products a second kernel sums in ascending order before b2 and
post.  Here the same algorithms, with the same Philox masks
(``keep_scale``), run at M = 3584 (B = 32, the flagship's batch) for the
four MLP geometries of the training path, and the backward's, whose
chunks differ, also at M = 3360 (B = 30, the DialogueRNN trainer's), at
rate 0 and at the path's dropout rates (FFN mid 0.1; head
pre, mid and post 0.2), and each output is held to ``mlp_plain`` or
``mlp_backward_plain`` within 1e-4 * max(1, max |ref|), the card tests'
limit.  Products of two TF32 values are exact in f32 and the sums are f32,
as on the tensor cores; the order of the sums inside a chunk differs from
the card's.

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


def first_layer(mm, x, w1, b1, pre, mid, dropout_seed):
    """(t1, a1, d1) of both kernels: t1 = pre(x), z1 = t1 W1 + b1 by ``mm``,
    a1 = mid(z1) and d1 = mid'(z1), each with its Philox mask."""
    (a_pre, a_mid, order, _), (r_pre, r_mid, _) = M._parse_chain(pre, mid, None)
    rows, K = x.shape
    H = w1.shape[1]
    t1 = x
    if a_pre is not None:
        t1 = _act(a_pre, x)
        if r_pre > 0:
            t1 = t1 * keep_scale(dropout_seed, STREAM_PRE, (rows, K), r_pre, x.device)
    z1 = mm(t1, w1) + b1
    if r_mid > 0:
        m = keep_scale(dropout_seed, STREAM_MID, (rows, H), r_mid, x.device)
        if order == "act_first":
            return t1, _act(a_mid, z1) * m, m * _act_grad(a_mid, z1)
        return t1, _act(a_mid, z1 * m), _act_grad(a_mid, z1 * m) * m
    return t1, _act(a_mid, z1), _act_grad(a_mid, z1)


def kernel_forward(mm, x, w1, b1, w2, b2, pre=None, mid=("relu", "act_first", 0.0), post=None,
                   dropout_seed=0):
    """out by mlp_fwd.cu's algorithm with the product ``mm``: a1 W2 over the
    d_ff chunks of ``fwd_split``, the partials summed in ascending order."""
    _, a1, _ = first_layer(mm, x, w1, b1, pre, mid, dropout_seed)
    (_, _, _, a_post), (_, _, r_post) = M._parse_chain(pre, mid, post)
    S, chunk = M.fwd_split(x.shape[0], w1.shape[1])
    z2 = mm(a1[:, :chunk], w2[:chunk])
    for s in range(1, S):
        z2 = z2 + mm(a1[:, s * chunk:(s + 1) * chunk], w2[s * chunk:(s + 1) * chunk])
    z2 = z2 + b2
    if a_post is None:
        return z2
    if r_post > 0:
        z2 = z2 * keep_scale(dropout_seed, STREAM_POST, z2.shape, r_post, x.device)
    return _act(a_post, z2)


def kernel_backward(mm, x, w1, b1, w2, b2, dout, pre=None, mid=("relu", "act_first", 0.0),
                    post=None, dropout_seed=0):
    """(dx, dw1, db1, dw2, db2) by mlp_bwd.cu's algorithm with the product ``mm``."""
    (a_pre, _, _, a_post), (r_pre, _, r_post) = M._parse_chain(pre, mid, post)
    rows, K = x.shape
    H, N = w2.shape

    def mask(stream, cols, rate):
        return keep_scale(dropout_seed, stream, (rows, cols), rate, x.device)

    t1, a1, d1 = first_layer(mm, x, w1, b1, pre, mid, dropout_seed)
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


def _inputs(rows, K, H, N, site, off_kink=True):
    """x, w1, b1, w2, b2, dout from a seed; for the relu FFN and off_kink, x
    away from relu's kink (``away_from_relu_kink``)."""
    rng = np.random.default_rng(rows + K + H + N)

    def randn(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x, w1, b1 = randn((rows, K), 1.0), randn((K, H), K ** -0.5), randn((H,), 0.05)
    if site == "ffn" and off_kink:
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
# the path's rows at L = 112: B = 32 (GAN_FFN), ids as PATH's, and B = 30
# (GAN_FFN_DialogueRNN), a partial last row tile, ids led by 3360
PATH_ROWS = [pytest.param(rows, *g, id="-".join(map(str, g if rows == ROWS else (rows, *g))))
             for rows in (ROWS, 3360) for g in PATH]


@pytest.mark.parametrize("rows,K,H,N,site,rate", PATH_ROWS)
def test_3xtf32_split_reductions_meet_the_limit(rows, K, H, N, site, rate):
    err = _error(mm_3x_fast, rows, K, H, N, site, rate)
    assert err <= GRAD_TOL, f"max |diff| / max(1, max |ref|) {err}"


@pytest.mark.parametrize("rows", [77, 3585])
def test_a_ragged_last_chunk_meets_the_limit(rows):
    K, H, N = 100, 512, 100
    launches = M.bwd_launches(rows, K, H, N)
    assert any(l["chunks"] > 1 and l["depth"] % l["chunk"] for l in launches), launches
    err = _error(mm_3x_fast, rows, K, H, N, "head", 0.2)
    assert err <= GRAD_TOL, f"max |diff| / max(1, max |ref|) {err}"


@pytest.mark.parametrize("rows,K,H,N,site,rate", PATH_ROWS)
def test_every_long_reduction_fills_the_card(rows, K, H, N, site, rate):
    """At M = 3584 and 3360 (a partial last row tile) dx, dW1 and dW2 each
    run >= 256 blocks (tiles x chunks) and at most one wave, in chunks of
    whole k-slices that cover the reduction; the workspace stays under 10
    MB."""
    for l in M.bwd_launches(rows, K, H, N):
        S, chunk, depth, tiles = l["chunks"], l["chunk"], l["depth"], l["tiles"]
        assert 256 <= l["blocks"] == tiles * S, l
        assert S == 1 or l["blocks"] <= M.WAVE_BLOCKS, l
        assert chunk % 32 == 0 and (S - 1) * chunk < depth <= S * chunk, l
    assert M.bwd_workspace_floats(rows, K, H, N) * 4 <= 10**7


def test_split_reduction_edges():
    assert M.split_reduction(265, 3584) == (1, 3584)  # over half a wave: no split
    assert M.split_reduction(264, 3584) == (2, 1792)  # half a wave: two chunks
    assert M.split_reduction(1, 20) == (1, 32)  # one slice: nothing to split
    assert M.split_reduction(1, 3584) == (112, 32)  # single k-slices
    assert M.split_reduction(16, 77) == (3, 32)  # 77 = 32 + 32 + 13
    assert M.split_reduction(18, 3584) == (28, 128)  # 29 asked; 4-slice chunks make 28


@pytest.mark.parametrize("K,H,N,site,rate", PATH)
@pytest.mark.parametrize("at_rate", [False, True])
def test_forward_3xtf32_chunks_meet_the_limit(K, H, N, site, rate, at_rate):
    """The forward at rate 0 and at the path's rate, on inputs drawn without
    the kink filter: relu is continuous, so a z1 near 0 moves out by no more
    than z1's own error."""
    x, w1, b1, w2, b2, _ = _inputs(ROWS, K, H, N, site, off_kink=False)
    cfg = _site(site, rate if at_rate else 0.0)
    got = kernel_forward(mm_3x_fast, x, w1, b1, w2, b2, **cfg, dropout_seed=ROWS + K)
    want = M.mlp_plain(x, w1, b1, w2, b2, **cfg, dropout_seed=ROWS + K)
    err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    assert err <= GRAD_TOL, f"max |diff| / max(1, max |ref|) {err}"


@pytest.mark.parametrize("rows,K,H,N,site,rate", PATH_ROWS)
def test_the_forward_fills_the_card(rows, K, H, N, site, rate):
    """At M = 3584 and 3360 the forward runs >= half a wave of blocks (row
    tiles x d_ff chunks), in chunks of whole 64-column tiles of at most
    FWD_CHUNK_TILES that cover d_ff; the workspace stays under 60 MB."""
    l = M.fwd_launch(rows, K, H, N)
    S, chunk = l["chunks"], l["chunk"]
    assert 2 * l["blocks"] >= M.WAVE_BLOCKS and l["blocks"] == l["row_tiles"] * S, l
    assert chunk % 64 == 0 and chunk <= 64 * M.FWD_CHUNK_TILES, l
    assert (S - 1) * chunk < H <= S * chunk, l
    assert M.fwd_workspace_floats(rows, K, H, N) == (S * rows * N if S > 1 else 0)
    assert M.fwd_workspace_floats(rows, K, H, N) * 4 <= 6e7


def test_fwd_split_edges():
    assert M.fwd_split(3584, 2048) == (8, 256)  # the a1 tile caps a chunk at 256 columns
    assert M.fwd_split(3584, 512) == (8, 64)  # 2 chunks would be 112 blocks: split to 8
    assert M.fwd_split(3584, 1024) == (8, 128)  # 9 asked; 2-tile chunks make 8
    assert M.fwd_split(1, 2048) == (32, 64)  # one row tile: single 64-column tiles
    assert M.fwd_split(20000, 100) == (1, 128)  # 313 row tiles fill half a wave unsplit
    assert M.fwd_split(20000, 300) == (2, 192)  # 626 blocks in the fewest chunks
    assert M.fwd_split(3584, 300) == (5, 64)
