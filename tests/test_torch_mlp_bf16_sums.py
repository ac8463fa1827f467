"""The bf16 MLP kernels' arithmetic, rehearsed on the CPU.

``csrc/mlp_fwd_bf16.cu`` and ``csrc/mlp_bwd_bf16.cu`` multiply bf16 operands
on the f64 tensor cores (``csrc/mlp_bf16_tile.cuh``): each warp loads its
bf16 fragments with ``ldmatrix``, widens every element to f64 (``f64_of``:
the register half as f32 bits, then the conversion unit), and runs four
``mma.sync.m16n8k4.f64`` per 16-deep k step, in which lane ``t`` carries the
logical ``k = 2t + (j & 1) + 8 (j >> 1)`` at hardware k ``t + 4j`` (the
pairs that ``ldmatrix`` hands a lane).  Each output adds its products one by
one in hardware-k order (``cli/dmma_probe.py`` measured this on the card).
The products of two bf16 values are exact in f64, so every sum is the exact
sum up to f64's reach, rounded to f32 once; the split launches add f64
partials of consecutive k chunks in ascending chunk order.

Here numpy runs the same algorithms: the kernels' conversion over every
bf16 bit pattern against torch's, the tile's k order and chunks in
f64 against the exact sum rounded to f32 once (the two may differ only where
the exact sum lies within f64's reach of an f32 rounding midpoint, and the
cases count those), and the z1 that both kernels compute, on rows placed at
relu's kink, bit for bit between the forward's d_ff chunks and the
backward's recompute's.
"""

import math

import numpy as np
import pytest
import torch

from gan_ffn_tpu_torch.ops import mlp as M

F32 = np.float32
NEAR = 2.0 ** -50  # an f64 sum this close to an f32 midpoint, relative to sum |terms|, may round either way
SLICE, STEP = 32, 16  # the rings' k-slice and the mma's k step (csrc/mlp_bf16_tile.cuh)
# hardware k (t + 4j) of a 16-deep step -> the logical k its lane carries there
HW_TO_K = np.array([2 * (hk % 4) + ((hk // 4) & 1) + 8 * ((hk // 4) >> 1) for hk in range(STEP)])


def f64_of(pair: np.ndarray, hi: bool) -> np.ndarray:
    """``mlp_bf16::f64_of``: the lower or upper bf16 of a 32-bit register as
    f32 bits, widened to f64."""
    bits = pair.astype(np.uint32) & np.uint32(0xFFFF0000) if hi else pair.astype(np.uint32) << np.uint32(16)
    with np.errstate(invalid="ignore"):  # NaN patterns stay NaN
        return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def _bf16_bits(values) -> np.ndarray:
    """The bf16 bits (uint16) of float32 values rounded to bf16."""
    t = torch.from_numpy(np.asarray(values, dtype=np.float32)).bfloat16()
    return t.view(torch.int16).numpy().view(np.uint16)


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("half", ["lower", "upper"])
def test_conversion_of_every_bf16(half):
    """All 65,536 bit patterns but the NaNs: the f64 bits equal torch's
    conversion, +-0, subnormals and +-inf included; NaNs stay NaN.  The
    kernels' ``f64_of`` takes the lower or the upper half of a register
    whose other half holds another pattern."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    other = bits[::-1].copy()
    if half == "lower":
        got = [f64_of((other << np.uint32(16)) | bits, False)]
    else:
        got = [f64_of((bits << np.uint32(16)) | other, True)]
    want = _bf16_values(bits.astype(np.uint16))
    nan = np.isnan(want)
    assert nan.sum() == 2 * 127
    exponent = (bits >> 7) & 0xFF
    assert ((exponent == 0) & ((bits & 0x7F) != 0)).sum() == 2 * 127  # the subnormals were there
    for g in got:
        assert np.array_equal(g[~nan].view(np.uint64), want[~nan].view(np.uint64))
        assert np.isnan(g[nan]).all()
        assert np.isinf(g).sum() == 2


def _bf16(rng, shape, scale=1.0, spread=0):
    """bf16 values (as f64) N(0, scale^2), their exponents spread over 2^+-spread."""
    v = rng.standard_normal(shape) * scale
    if spread:
        v = v * np.exp2(rng.integers(-spread, spread + 1, shape))
    return _bf16_values(_bf16_bits(v))


def tile_product(a: np.ndarray, b: np.ndarray, chunk: int = 0) -> np.ndarray:
    """The kernels' f64 sums of ``a (M, K) @ b (K, N)`` (bf16 values):
    k in 32-deep slices (zero past K), each slice two 16-deep mma steps that
    add their products in the hardware's k order, one k chunk of ``chunk``
    (0: all of K) per accumulator, the chunks' f64 partials then summed in
    ascending chunk order (the split launches' reduce kernels)."""
    K = a.shape[1]
    Kp = -(-K // SLICE) * SLICE
    a = np.pad(a, ((0, 0), (0, Kp - K)))
    b = np.pad(b, ((0, Kp - K), (0, 0)))
    chunk = chunk or Kp
    total = np.zeros((a.shape[0], b.shape[1]))
    for c0 in range(0, Kp, chunk):
        acc = np.zeros_like(total)
        for k0 in range(c0, min(c0 + chunk, Kp), STEP):
            for k in k0 + HW_TO_K:
                acc = acc + a[:, k, None] * b[None, k, :]  # exact product, one f64 rounding
        total = total + acc
    return total


def _rn_f32_exact(terms: np.ndarray) -> np.float32:
    """The exact sum of f64 ``terms`` rounded to f32 once (round to nearest, ties to even)."""
    from fractions import Fraction

    exact = sum((Fraction(float(t)) for t in terms), Fraction(0))
    f = F32(float(exact))  # f64 then f32: may round twice, so check both neighbours
    best = f
    for cand in (np.nextafter(f, F32(-np.inf)), np.nextafter(f, F32(np.inf))):
        d_best, d_cand = abs(Fraction(float(best)) - exact), abs(Fraction(float(cand)) - exact)
        if d_cand < d_best or (d_cand == d_best and int(cand.view(np.uint32)) % 2 == 0):
            best = cand
    return best


def _near_midpoint(s64: float, scale: float) -> bool:
    """An f64 sum within NEAR * scale of a midpoint between two f32 neighbours."""
    f = F32(s64)
    for other in (np.nextafter(f, F32(-np.inf)), np.nextafter(f, F32(np.inf))):
        mid = (float(f) + float(other)) / 2
        if abs(s64 - mid) <= NEAR * scale:
            return True
    return False


def _check_against_exact(a, b, got, what, chunk=0):
    """got (f64 sums) rounded to f32 against the exact sums rounded once:
    equal but within NEAR of a midpoint, where they may differ; returns the
    count of such near cases."""
    K = a.shape[1]
    near = differ = 0
    prods = a[:, :, None] * b[None, :, :]  # (M, K, N), exact
    got32 = got.astype(np.float32)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            terms = prods[i, :, j]
            s = math.fsum(terms)
            if _near_midpoint(s, float(np.abs(terms).sum())):
                near += 1
                continue
            if got32[i, j] != F32(s):  # fsum is the exact sum rounded to f64 once: far from a midpoint it rounds as the exact sum does
                differ += 1
                assert got32[i, j] == _rn_f32_exact(terms), (what, i, j, K, chunk)
    assert differ == 0, (what, differ)
    return near


@pytest.mark.parametrize("rows,K,N,spread", [
    (64, 100, 64, 0),     # z1 of the 100-wide FFNs and heads: K padded to 128
    (64, 512, 64, 0),     # z1 of the visual FFN, dx of the heads (over H = 512)
    (32, 2048, 16, 0),    # dx of the FFNs (over d_ff)
    (16, 96, 16, 30),     # operands whose scales spread over 2^+-30
])
def test_tile_sums_round_as_the_exact_sums(rows, K, N, spread):
    rng = np.random.default_rng(K + N + spread)
    a, b = _bf16(rng, (rows, K), 1.0, spread), _bf16(rng, (K, N), K ** -0.5, spread)
    _check_against_exact(a, b, tile_product(a, b), f"{rows}x{K}x{N}")


@pytest.mark.parametrize("geometry,name", [
    ((100, 512, 100), "dx"), ((100, 512, 100), "z2"), ((100, 2048, 100), "dw1"),
    ((512, 1024, 100), "dw1"), ((512, 1024, 100), "dw2"), ((100, 512, 100), "dw2"),
])
def test_split_reductions_round_as_the_exact_sums(geometry, name):
    """The split launches' chunks (``ops.mlp.bwd_bf16_launches`` at M =
    3584), each an f64 partial, summed in ascending chunk order: on a few
    output rows and columns of the full reduction."""
    K, H, N = geometry
    launch = {l["name"]: l for l in M.bwd_bf16_launches(3584, K, H, N)}[name]
    depth, chunk = launch["depth"], launch["chunk"]
    assert launch["chunks"] > 1
    rng = np.random.default_rng(depth + chunk)
    a, b = _bf16(rng, (6, depth), 1.0), _bf16(rng, (depth, 5), 0.05)
    _check_against_exact(a, b, tile_product(a, b, chunk), name, chunk)


def test_sums_near_f32_midpoints_and_under_cancellation():
    """Products that cancel to leave a sum far below the terms, and sums
    built to land within a few f64 ulps of an f32 midpoint: equal to the
    exact sum rounded once but in the near cases, which this counts."""
    rng = np.random.default_rng(7)
    a = _bf16(rng, (16, 64), 1.0)
    b = _bf16(rng, (64, 16), 1.0)
    b[32:] = -b[:32] * (a[:, :32].mean() / a[:, 32:].mean())  # heavy cancellation
    b = _bf16_values(_bf16_bits(b))
    got = tile_product(a, b)
    near = _check_against_exact(a, b, got, "cancellation")
    assert near < a.shape[0] * b.shape[1]


def _z1_by_blocks(t1, w1, b1, chunk, order=None):
    """z1 = f32(t1 W1) + b1 as a kernel computes it whose blocks take d_ff
    in chunks of ``chunk`` columns: each block's 64-column tiles in turn,
    each tile's sums in the tile's k order (``order``: another k order)."""
    H = w1.shape[1]
    product = order or tile_product
    z = np.empty((t1.shape[0], H), dtype=np.float32)
    for h0 in range(0, H, chunk):
        for j0 in range(h0, min(h0 + chunk, H), 64):
            cols = slice(j0, min(j0 + 64, H))
            z[:, cols] = product(t1, w1[:, cols]).astype(np.float32)
    return z + b1.astype(np.float32)


def _reversed(a, b):
    """The f64 sums in the opposite k order."""
    acc = np.zeros((a.shape[0], b.shape[1]))
    for k in range(a.shape[1] - 1, -1, -1):
        acc = acc + a[:, k, None] * b[None, k, :]
    return acc


def _in_f32(a, b):
    """Another arithmetic: each product rounded to f32 and summed in f32."""
    acc = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for k in range(a.shape[1]):
        acc = acc + (a[:, k, None] * b[None, k, :]).astype(np.float32)
    return acc


@pytest.mark.parametrize("K,pre,fwd_chunk,z1_chunk", [
    (100, None, 320, 320),   # the H100's splits at M = 3584 (test_torch_kernels_cuda's table)
    (512, None, 256, 512),   # the forward's and the recompute's chunks differ
    (100, "gelu", 320, 320),
    (512, None, 64, 2048),   # one row tile's single tiles against one chunk of all of d_ff
])
def test_z1_recompute_matches_the_forward_at_the_kink(K, pre, fwd_chunk, z1_chunk):
    """Rows at relu's kink (``chip_smoke.py``'s ``mlp_relu_branches_bf16``:
    x0 plus bf16 noise of 2^-7, b1 = -(t(x0) W1) rounded to bf16), H = 2048:
    the forward's z1 over its d_ff chunks and the backward's recompute over
    its own equal in every bit, so relu' takes the branch relu took.  Both
    are order-free: the f64 sums in the opposite k order give the same bits,
    so neither the chunk that holds a tile nor the k order can move a z1.
    The rows can tell another arithmetic: summed in f32, many z1 change
    bits, and many lie within a few f32 ulps of 0."""
    H, groups = 2048, 4
    rng = np.random.default_rng(K + 3)
    w1 = _bf16(rng, (K, H), K ** -0.5)
    other = near = 0
    for _ in range(groups):  # each group of 8 rows has its own b1
        x0 = rng.standard_normal(K).astype(np.float32)
        x = _bf16_values(_bf16_bits(x0 + 2.0 ** -7 * rng.standard_normal((8, K))))
        t0 = _bf16_values(_bf16_bits(x0)).astype(np.float64)
        if pre == "gelu":
            t0 = torch.nn.functional.gelu(torch.from_numpy(t0)).numpy()
            x = _bf16_values(_bf16_bits(torch.nn.functional.gelu(torch.from_numpy(x).float()).numpy()))
        b1 = _bf16_values(_bf16_bits(-(t0 @ w1)))
        fwd = _z1_by_blocks(x, w1, b1, fwd_chunk)
        bwd = _z1_by_blocks(x, w1, b1, z1_chunk)
        assert np.array_equal(fwd.view(np.uint32), bwd.view(np.uint32))
        assert np.array_equal(fwd > 0, bwd > 0)
        rev = _z1_by_blocks(x, w1, b1, z1_chunk, _reversed)
        assert np.array_equal(fwd.view(np.uint32), rev.view(np.uint32))
        f32 = _z1_by_blocks(x, w1, b1, z1_chunk, _in_f32)
        other += int((f32.view(np.uint32) != fwd.view(np.uint32)).sum())
        near += int((np.abs(fwd) < 2.0 ** -12).sum())
    assert other > 0 and near > 0
