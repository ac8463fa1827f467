"""TF32 arithmetic of the port's tensor-core kernels, emulated on the CPU.

``csrc/mma_tf32.cuh`` rounds f32 operands to TF32 (10 of f32's 23 mantissa
bits) by integer add and mask: round to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` does for finite inputs.  Products of two TF32 values are
exact in f32, and the tensor cores sum them in f32.
"""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (nearest, ties away from zero; low 13 bits cleared).
    Finite inputs only, as in the kernels."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a tf32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the 3xTF32 split (``split``): a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_3x_fast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the 3xTF32 split of ``split_fast``: lo = x - hi is left
    unrounded, and the tensor core truncates it."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = truncate(a - a_hi), truncate(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_1x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


# relu inputs kept this far from 0: 6x the largest |z1| error seen in f32
RELU_KINK = 2e-5


def away_from_relu_kink(x, w1, b1, redraw):
    """x with its rows replaced by ``redraw(n)`` (n new rows) where z1 =
    x w1 + b1 comes within RELU_KINK of 0; only for holding a kernel's
    gradients against the plain version.  The MLP kernels compute z1 in
    3xTF32, the plain version in f32 with another order of the sums, up to
    a few 1e-6 apart at K = 512.  Where z1 is that close to relu's kink the
    two take different branches of relu', and the gradients differ by O(1)
    there: a comparison would measure the branch, not the arithmetic.  The
    two kernels compute z1 the same way and agree on the kink, which the
    card tests check at inputs built to lie on it."""
    while True:
        near = ((x.double() @ w1.double() + b1.double()).abs() < RELU_KINK).any(1)
        if not near.any():
            return x
        x[near] = redraw(int(near.sum().item()))
