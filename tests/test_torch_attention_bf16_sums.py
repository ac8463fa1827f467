"""The bf16 attention kernels' exact sums, rehearsed on the CPU.

``csrc/attention_fwd_bf16.cu`` and ``csrc/attention_bwd_bf16.cu`` take every
sum that the plain versions (``ops/attention.py`` at bf16) take exactly, and
round it to f32 once.  Their k steps (one bf16 ``mma.sync`` each, f32 from a
zeroed accumulator) are added as an f32 pair hi + lo with Knuth's TwoSum
(``csrc/mma_bf16.cuh``: ``two_sum``, ``bf16::Acc``) in step order, and the
pair is rounded once; the softmax's row sums and D are summed in f64, each
warp of a 16-row group over its half of the keys (part 0: keys 0 .. 63,
part 1: keys 64 .. 127), the four lanes of a row by butterfly shuffles, then
the two halves in a fixed order (part 0 first).  The weights are divided by
their row sum through one reciprocal a row and two FMA corrections
(``div_rn``).  Here numpy float32, whose operations round to nearest as the
kernels' explicit ``__fadd_rn``/``__fmaf_rn`` do, runs the same algorithms,
and every result is held to the exact sum (integers) rounded to f32 once,
which is what the kernels' previous f64 adds gave: the two may differ only
where the exact sum lies within 2^-40 of the terms' magnitude from an f32
rounding midpoint (``NEAR``), and the cases here count those.

The tensor core's own k-step sum (which truncates) is modelled as the
nearest f32 of the step's 16 exact products: what is under test is the sum
of the steps, whatever each step gives.
"""

import fractions
import math

import numpy as np
import pytest
import torch

from gan_ffn_tpu_torch.ops import attention as A

F32 = np.float32
NEAR = 2.0 ** -40  # a sum this close to a midpoint, relative to sum |terms|, may round either way


def _scaled(x) -> int:
    """An f32 value as the integer x * 2^149 (exact)."""
    p, q = float(x).as_integer_ratio()
    return p * ((1 << 149) // q)


def _rn_f32(n: int) -> np.float32:
    """n * 2^-149 rounded to the nearest f32, ties to even."""
    if n == 0:
        return F32(0.0)
    a = abs(n)
    shift = max(a.bit_length() - 24, 0)
    q, r = divmod(a, 1 << shift)
    if shift and (2 * r > (1 << shift) or (2 * r == (1 << shift) and q & 1)):
        q += 1
    return F32(math.copysign(math.ldexp(q, shift - 149), n))


def _near_midpoint(n: int, scale: int) -> bool:
    """The exact sum n * 2^-149 lies within NEAR * scale * 2^-149 of a
    midpoint between two neighbouring f32 values, but not on it (a sum on a
    midpoint fits the pair exactly and rounds to even on both paths)."""
    r = _rn_f32(n)
    if not np.isfinite(r):
        return False
    up = _scaled(np.nextafter(r, F32(np.inf)))
    down = _scaled(np.nextafter(r, F32(-np.inf)))
    here = _scaled(r)
    mids = (fractions.Fraction(here + up, 2), fractions.Fraction(here + down, 2))
    return 0 < min(abs(n - m) for m in mids) <= NEAR * scale


def two_sum(hi, lo, x):
    """``bf16::two_sum``: hi + lo += x, every operation an f32 rounding."""
    s = F32(hi + x)
    xs = F32(s - hi)
    hs = F32(s - xs)
    lo = F32(lo + F32(F32(hi - hs) + F32(x - xs)))
    return s, lo


def pair_sum(steps):
    """The kernels' sum of k-step partials (f32 arrays, in step order): the
    first step is hi, the rest added by two_sum, rounded once."""
    hi, lo = steps[0].astype(F32), np.zeros_like(steps[0], dtype=F32)
    for c in steps[1:]:
        hi, lo = two_sum(hi, lo, c.astype(F32))
    return F32(hi + lo)


def f64_sum(steps):
    """The previous kernels' sum: each step added in f64, rounded once."""
    total = np.zeros(steps[0].shape, dtype=np.float64)
    for c in steps:
        total = total + c.astype(np.float64)
    return total.astype(F32)


def _check_sums(steps, got, what):
    """got (and the f64 path) against the exact sum rounded to f32, element
    by element, outside NEAR; returns the number of NEAR elements."""
    flat = [np.asarray(c, dtype=F32).ravel() for c in steps]
    want64 = f64_sum(flat)
    got = np.asarray(got, dtype=F32).ravel()
    near = 0
    for i in range(got.size):
        terms = [_scaled(c[i]) for c in flat]
        exact = sum(terms)
        if _near_midpoint(exact, sum(abs(x) for x in terms)):
            near += 1
            continue
        want = _rn_f32(exact)
        assert got[i] == want, f"{what}: element {i}: {got[i]!r} != exact {want!r}"
        assert want64[i] == want, f"{what}: element {i}: the f64 path gives {want64[i]!r}"
    return near


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(F32)).bfloat16().float().numpy()


def _k_steps(a, b, width=16):
    """The k-step partials of a @ b: the nearest f32 of each 16-wide slice's
    exact sum (bf16 products are exact in f64, and 16 of them too)."""
    steps = []
    for k0 in range(0, a.shape[1], width):
        steps.append((a[:, k0:k0 + width].astype(np.float64)
                      @ b[k0:k0 + width].astype(np.float64)).astype(F32))
    return steps


def test_two_sum_is_error_free():
    rng = np.random.default_rng(0)
    hi = (rng.standard_normal(4000) * 2.0 ** rng.integers(-30, 30, 4000)).astype(F32)
    x = (rng.standard_normal(4000) * 2.0 ** rng.integers(-30, 30, 4000)).astype(F32)
    x[:100] = -hi[:100]  # cancel exactly
    s, lo = two_sum(hi, np.zeros_like(hi), x)
    for i in range(hi.size):
        assert _scaled(s[i]) + _scaled(lo[i]) == _scaled(hi[i]) + _scaled(x[i]), i
        assert not (lo[i] == 0 and np.signbit(lo[i])), "lo never becomes -0"


@pytest.mark.parametrize("Dh,L", [(10, 17), (10, 112), (64, 37), (64, 112), (64, 128)])
def test_attention_sums_round_as_the_exact_sums(Dh, L):
    """S = Q K^T over Dh / 16 k steps and O = P V over ceil(valid_len / 16)
    16-key steps (the rounded weights), each summed as the kernels do, are
    the exact sums rounded to f32."""
    rng = np.random.default_rng(Dh * 1000 + L)
    Dp = 16 if Dh <= 16 else 32 if Dh <= 32 else 64
    q, k, v = (np.pad(_bf16(rng, (L, Dh)), ((0, 0), (0, Dp - Dh))) for _ in range(3))
    valid_len = int(rng.integers(1, L + 1))
    steps = _k_steps(q, k.T)
    scores = pair_sum(steps)
    near = _check_sums(steps, scores, f"S at Dh={Dh}")
    s = scores.astype(np.float64) * (1.0 / math.sqrt(Dh))
    s[:, valid_len:] = -np.inf
    e = np.exp(s - s.max(axis=1, keepdims=True)).astype(F32)
    p = torch.from_numpy((e / e.astype(np.float64).sum(1, keepdims=True).astype(F32)).astype(F32))
    p = p.bfloat16().float().numpy()
    pv_steps = _k_steps(p[:, :16 * ((valid_len + 15) // 16)], v, 16)
    near += _check_sums(pv_steps, pair_sum(pv_steps), f"P V at L={L}")
    assert near <= 2, f"{near} sums within NEAR of a midpoint"


def test_sums_near_rounding_boundaries_and_under_cancellation():
    """Sums an f32 ulp or less from an f32 midpoint or a bf16 midpoint, and
    sums whose terms cancel down by 2^20, round as the exact sum does."""
    one = F32(1.0)
    ulp = F32(2.0 ** -23)
    cases = []
    for d in (2.0 ** -30, 2.0 ** -34, 2.0 ** -38):  # f32 midpoint 1 + 2^-23 + 2^-24, plus or minus d
        for sign in (1, -1):
            cases.append([one + ulp, F32(2.0 ** -25), F32(2.0 ** -25), F32(sign * d)])
            cases.append([F32(2.0 ** -24), one + ulp, F32(sign * d), F32(0.0)])
    for off in (0.25, 0.75, 1.25):  # bf16 midpoint 1 + 2^-8, plus or minus a part of an f32 ulp
        for sign in (1, -1):
            cases.append([one, F32(2.0 ** -8), F32(sign * off * 2.0 ** -23), F32(0.0)])
            cases.append([F32(2.0 ** -9), one, F32(2.0 ** -9), F32(sign * off * 2.0 ** -23)])
    for terms in cases:
        steps = [np.array([t], dtype=F32) for t in terms]
        near = _check_sums(steps, pair_sum(steps), f"terms {terms}")
        assert near == 0, f"terms {terms}: within NEAR of a midpoint"
    # terms of 2^20 that cancel down to 2^-2 .. 2^-10: every error the pair
    # carries is exact, so it rounds as the exact sum does, where NEAR
    # (relative to the terms) would excuse a difference; an f64 sum loses
    # the low bits of a small first term here (0.0007 + 2^20)
    big = F32(2.0 ** 20)
    for a, b in ((0.375, -0.125), (1e-3, 7e-4), (0.5, 0.5)):
        for terms in ([big + F32(a), -big, F32(b), F32(2.0 ** -20)],
                      [F32(b), big, F32(a), -big, F32(2.0 ** -21), F32(-3e-7), F32(1e-5)]):
            steps = [np.array([t], dtype=F32) for t in terms]
            exact = _rn_f32(sum(_scaled(t) for t in terms))
            assert abs(float(exact)) < 2.0 ** -1 * float(big) * 2.0 ** -18
            assert pair_sum(steps)[0] == exact, terms
    # within 2^-50 of the midpoint, the pair may lose the last bits and round
    # to even where the exact sum does not: the documented exception
    steps = [np.array([t], dtype=F32) for t in (one + ulp, F32(2.0 ** -24), F32(2.0 ** -50))]
    exact = sum(_scaled(c[0]) for c in steps)
    assert _near_midpoint(exact, exact)


def _row_sum_split(e):
    """The kernels' row sum of the exp weights (f32, one row of up to 128
    keys, zero-padded): each warp's half over its thread's 16 values in tile
    order, the four lanes of the row by the butterfly (xor 1, then xor 2),
    part 0's half plus part 1's, all in f64, rounded to f32 once."""
    e = np.pad(e, (0, 128 - e.size)).astype(F32)
    halves = []
    for part in range(2):
        lanes = []
        for t in range(4):
            acc = 0.0
            for n in range(8):
                j = 64 * part + 8 * n + 2 * t
                acc += float(e[j]) + float(e[j + 1])
            lanes.append(acc)
        halves.append((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
    return F32(halves[0] + halves[1])


def test_split_row_sum_is_the_whole_rows_sum():
    rng = np.random.default_rng(3)
    for trial in range(300):
        L = int(rng.integers(1, 129))
        s = rng.standard_normal(L) * float(rng.choice([0.5, 3.0, 12.0]))
        s[int(rng.integers(1, L + 1)):] = -np.inf
        e = np.exp(s - s.max()).astype(F32)
        whole = F32(e.astype(np.float64).sum())
        assert _row_sum_split(e) == whole, trial
        exact = sum(_scaled(x) for x in e)
        if not _near_midpoint(exact, exact):
            assert whole == _rn_f32(exact), trial


def _fma(a, b, c):
    """fmaf(a, b, c) for arrays: a b + c exactly, rounded to f32 once."""
    prod = a.astype(np.float64) * b.astype(np.float64)  # exact: 48 bits
    total = prod + c.astype(np.float64)
    out = total.astype(F32)
    # f64 may have rounded the sum onto an f32 midpoint: settle those exactly
    for i in np.nonzero(out.astype(np.float64) != total)[0]:
        exact = fractions.Fraction(float(prod[i])) + fractions.Fraction(float(c[i]))
        candidates = (out[i], np.nextafter(out[i], F32(np.inf)), np.nextafter(out[i], F32(-np.inf)))
        best = min(candidates, key=lambda r: (abs(fractions.Fraction(float(r)) - exact),
                                              int(np.asarray(r).view(np.int32)) & 1))
        out[i] = best
    return out


def div_rn(x, d, y):
    """``div_rn``: x / d from y = 1 / d rounded, and two FMA corrections."""
    q = (x * y).astype(F32)
    q = _fma(_fma(-q, d, x), y, q)
    return _fma(_fma(-q, d, x), y, q)


def test_softmax_division_is_correctly_rounded():
    rng = np.random.default_rng(5)
    n = 20000
    x = np.minimum(2.0 ** rng.uniform(-64, 0, n) * rng.uniform(1, 2, n), 1.0).astype(F32)
    d = rng.uniform(1, 128, n).astype(F32)
    d[: n // 4] = (1 + rng.integers(0, 2 ** 12, n // 4) * 2.0 ** -23).astype(F32)  # just above 1
    x[n // 4: n // 2] = (1 - rng.integers(0, 2 ** 16, n // 4) * 2.0 ** -24).astype(F32)  # just below 1
    x[:50] = 0.0
    y = (F32(1.0) / d).astype(F32)
    np.testing.assert_array_equal(div_rn(x, d, y), (x / d).astype(F32))
    # the theorem's premise: after one correction the remainder is exact in f32
    q = (x * y).astype(F32)
    q1 = _fma(_fma(-q, d, x), y, q)
    rem = x.astype(np.float64) - q1.astype(np.float64) * d.astype(np.float64)  # exact in f64
    np.testing.assert_array_equal(rem.astype(F32).astype(np.float64), rem)


def test_plain_bf16_attention_sums_exactly():
    """The plain version the kernels are held to takes the same exact sums:
    its bf16 scores are the exact sums of Q K^T rounded to f32."""
    rng = np.random.default_rng(9)
    q, k = (torch.from_numpy(_bf16(rng, (1, 1, 40, 64))).bfloat16() for _ in range(2))
    got = A.exact_matmul(q, k.transpose(-1, -2))[0, 0].numpy()
    qn, kn = q.float().numpy()[0, 0], k.float().numpy()[0, 0]
    for i, j in ((0, 0), (5, 17), (39, 39), (20, 3)):
        exact = sum(_scaled(F32(a * b)) for a, b in zip(qn[i], kn[j]))  # bf16 products are exact in f32
        assert got[i, j] == _rn_f32(exact)
