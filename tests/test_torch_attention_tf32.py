"""Why the attention kernels split every f32 operand into two TF32 halves.

``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` run their products
on the tensor cores as TF32 ``mma.sync``.  TF32 keeps 10 of f32's 23 mantissa
bits, so each kernel splits an operand x into ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` and sums ``a_lo b_hi + a_hi b_lo + a_hi b_hi``
(3xTF32, ``csrc/mma_tf32.cuh``).  This file emulates both choices on the CPU
(TF32 rounding by bit masking: round to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` and the kernels' integer rounding do) with the kernels'
algorithm, and holds them to the plain versions with the card tests' limits:

- 3xTF32 stays within them: forward max |diff| <= 1e-5, and each gradient of
  the five backward products within 1e-4 * max(1, max |ref|);
- a single TF32 pass does not.

Products of two TF32 values are exact in f32, and the sums are taken in f32,
as the tensor cores do; the order of the sums differs from the card's.
"""

import math

import numpy as np
import pytest
import torch
from tf32_emulation import mm_1x, mm_3x, tf32

from gan_ffn_tpu_torch.ops import attention as A
from gan_ffn_tpu_torch.ops.dropout import STREAM_ATTENTION, keep_scale

FWD_TOL = 1e-5
GRAD_TOL = 1e-4  # relative to max(1, max |ref|)
B, L = 4, 112


def _weights(mm, q, k, valid_len, rate, seed):
    """(P, P * M): the kernels' softmax with their product ``mm``."""
    Dh = q.shape[-1]
    s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    s = s.masked_fill(torch.arange(L) >= valid_len, A.NEG_INF)
    p = torch.softmax(s, dim=-1)
    mask = keep_scale(seed, STREAM_ATTENTION, p.shape, rate, q.device) if rate > 0 else 1.0
    return p, p * mask, mask


def forward(mm, q, k, v, valid_len, rate, seed):
    _, a, _ = _weights(mm, q, k, valid_len, rate, seed)
    return mm(a, v)


def backward(mm, q, k, v, dout, valid_len, rate, seed):
    """attention_bwd.cu's five products: S, dP, dV, dQ, dK."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, a, mask = _weights(mm, q, k, valid_len, rate, seed)
    dv = mm(a.transpose(-1, -2), dout)
    dp = mm(dout, v.transpose(-1, -2)) * mask
    d = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - d) * scale
    return mm(ds, k), mm(ds.transpose(-1, -2), q), dv


def _inputs(H, Dh):
    rng = np.random.default_rng(H * 100 + Dh)
    return [torch.from_numpy(rng.standard_normal((B, H, L, Dh)).astype(np.float32))
            for _ in range(4)]


def _errors(mm, H, Dh, valid_len, rate):
    q, k, v, dout = _inputs(H, Dh)
    seed = 17 + valid_len
    fwd = (forward(mm, q, k, v, valid_len, rate, seed)
           - A.attention_plain(q, k, v, valid_len, rate, seed)).abs().max().item()
    got = backward(mm, q, k, v, dout, valid_len, rate, seed)
    want = A.attention_backward_plain(q, k, v, dout, valid_len, rate, seed)
    bwd = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
              for g, w in zip(got, want))
    return fwd, bwd


CASES = [(H, Dh, vl, rate) for H, Dh in ((10, 10), (8, 64)) for vl in (112, 90, 1)
         for rate in (0.0, 0.1)]


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2**-23, -(1 + ulp / 2), 1 + 1.5 * ulp, 3.0e-39])
    want = torch.tensor([1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0e-39])
    got = tf32(x)
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(got[5].item() - 3.0e-39) <= 2.0 ** -136  # subnormals keep 10 bits below 2^-126


@pytest.mark.parametrize("H,Dh,valid_len,rate", CASES)
def test_3xtf32_meets_the_kernel_limits(H, Dh, valid_len, rate):
    fwd, bwd = _errors(mm_3x, H, Dh, valid_len, rate)
    assert fwd <= FWD_TOL, f"forward max |diff| {fwd}"
    assert bwd <= GRAD_TOL, f"backward max |diff| / max(1, max |ref|) {bwd}"


@pytest.mark.parametrize("H,Dh,valid_len,rate", CASES)
def test_one_tf32_pass_misses_them(H, Dh, valid_len, rate):
    fwd, bwd = _errors(mm_1x, H, Dh, valid_len, rate)
    assert fwd > FWD_TOL, f"forward max |diff| {fwd}"
    assert bwd > GRAD_TOL, f"backward max |diff| / max(1, max |ref|) {bwd}"
