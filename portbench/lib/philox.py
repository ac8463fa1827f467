"""A frozen copy of the port's dropout stream (``gan_ffn_tpu_torch/ops/dropout.py``):
Philox4x32-10 masks addressed by ``(seed, stream, flat index)``.

The reference draws the in-kernel dropout masks from this copy, so it
imports nothing of the port.  ``tests/test_portbench_philox.py`` holds it
to the port's module bit for bit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

STREAM_ATTENTION, STREAM_PRE, STREAM_MID, STREAM_POST, STREAM_DERIVE = 0, 1, 2, 3, 4

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_SEED_BITS = 0x7FFFFFFF
ROUNDS = 10


def _mulhilo(a, b: int):
    """(high, low) 32-bit words of ``a * b`` for int64 ``a`` in [0, 2**32)."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter: Sequence, key: Tuple):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def derive_seed(base: int, index: int) -> int:
    """The seed of call ``index`` of a step whose seed base is ``base``."""
    x, y, _, _ = philox4x32((index, 0, STREAM_DERIVE, 0), (base & _MASK32, (base >> 32) & _MASK32))
    return ((y & _SEED_BITS) << 32) | x


def random_bits(seed: int, stream: int, n: int, device=None) -> torch.Tensor:
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    words = philox4x32((groups & _MASK32, groups >> 32, zero + stream, zero),
                       (seed & _MASK32, (seed >> 32) & _MASK32))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def keep_scale(seed: int, stream: int, shape: Sequence[int], rate: float,
               device=None) -> torch.Tensor:
    """float32 mask of ``shape``: ``1 / (1 - rate)`` where kept, else 0."""
    threshold = min(int(rate * 2**32), 2**32 - 1)
    bits = random_bits(seed, stream, math.prod(int(d) for d in shape), device)
    return ((bits >= threshold).to(torch.float32) * (1.0 / (1.0 - rate))).reshape(tuple(shape))


class StepStream:
    """The k-th kernel call of a step that draws a mask gets ``derive_seed(base, k)``."""

    def __init__(self, base: int):
        self.base, self.calls = int(base), 0

    def next(self) -> int:
        seed = derive_seed(self.base, self.calls)
        self.calls += 1
        return seed
